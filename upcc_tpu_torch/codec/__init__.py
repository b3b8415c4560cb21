"""Codec: container format and compress/decompress orchestration."""

from .codec import Codec
from . import bitstream
