"""Model modules of the codec: g_a/g_s, GDN, the entropy models and the
joint model."""

from .unified import UnifiedModel, occupancy_color_features
from .transforms import AnalysisTransform, SparseSynthesisTransform
from .gdn import GDN
from .entropy.hyperprior import MeanScaleHyperprior
from .entropy.bottleneck import FactorizedBottleneck
