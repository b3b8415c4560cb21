"""Quality metrics (host numpy/scipy): D1/D2/YUV PSNR, native PCQM,
Bjøntegaard deltas, renders and the external anchor hooks."""

from .metrics import pc_metrics, PointCloudMetric, estimate_normals
from .bjontegaard import bd_rate, bd_psnr, BjontegaardModel
