"""Evaluation: generative metrics (FID, ISC, KID, PRC), the InceptionV3-compat
extractor, the TF1-exact resize and the metric pipeline, the JAX package's
``eval/`` without VGG16, LPIPS, PPL, CLIP and DINOv2 (ROADMAP queue 1 item
8b)."""

from . import metrics, registry  # noqa: F401
from .inception import InceptionV3, create_extractor  # noqa: F401
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
from .resize import resize_bilinear_tf1  # noqa: F401
