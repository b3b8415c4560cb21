"""Codec: container format and compress/decompress orchestration."""
