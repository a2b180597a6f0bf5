"""Evaluation, the JAX package's ``eval/``: generative metrics (FID, ISC, KID,
PRC, PPL), the InceptionV3-compat, VGG16, CLIP and DINOv2 extractors, the
LPIPS sample similarity, the TF1-exact resize and the metric pipeline."""

from . import metrics, registry  # noqa: F401
from .clip import CLIP_NAMES, CLIPExtractor, create_clip_extractor  # noqa: F401
from .dinov2 import DINOV2_NAMES, DINOv2Extractor, create_dinov2_extractor  # noqa: F401
from .inception import InceptionV3, create_extractor  # noqa: F401
from .lpips import LPIPS, VGG16, create_lpips, create_vgg16  # noqa: F401
from .metrics import (  # noqa: F401
    fid_features_to_metric,
    fid_features_to_statistics,
    fid_statistics_to_metric,
    isc_features_to_metric,
    kid_features_to_metric,
    prc_features_to_metric,
)
from .pipeline import (  # noqa: F401
    GenerativeModel,
    calculate_metrics,
    register_dataset,
    registered_datasets,
)
from .ppl import (  # noqa: F401
    INTERPOLATIONS,
    batch_lerp,
    batch_slerp_any,
    batch_slerp_unit,
    calculate_ppl,
)
from .resize import resize_bilinear_tf1  # noqa: F401
