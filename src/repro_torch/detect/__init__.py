"""Detection plane (port of `repro/detect/`): async sweeps, shape buckets,
sweep guard, and the pluggable score-model families.

The async half runs detection sweeps (EM refits + window scoring) off the
step thread, on snapshots, with results admitted back at the next cadence
point. The family half (`repro_torch.detect.families`) is the bake-off's
model zoo: isolation ensemble, MAD floor, and spectral residual behind one
score convention, pluggable beside the GMM via the session detector
registry. The families are NumPy on the host, as in the reference; the GMM
is the only detector that runs on the card. The reference's
``enable_persistent_cache`` has no counterpart: nothing compiles per shape.
"""
from repro_torch.detect.cache import (MIN_BUCKET, SHAPE_CACHE,
                                      ShapeBucketCache, bucket_rows,
                                      pad_to_bucket)
from repro_torch.detect.executor import DetectionExecutor, SweepResult
from repro_torch.detect.families import (MODEL_FAMILIES, ModelStackMonitor,
                                         ScoreModel, model_factory)
from repro_torch.detect.guard import detection_zone, in_detection_zone
from repro_torch.detect.isoforest import IsolationEnsemble
from repro_torch.detect.robust import RobustMADModel
from repro_torch.detect.spectral import SpectralResidualModel

__all__ = [
    "MIN_BUCKET",
    "SHAPE_CACHE",
    "ShapeBucketCache",
    "bucket_rows",
    "pad_to_bucket",
    "DetectionExecutor",
    "SweepResult",
    "detection_zone",
    "in_detection_zone",
    "MODEL_FAMILIES",
    "ModelStackMonitor",
    "ScoreModel",
    "model_factory",
    "IsolationEnsemble",
    "RobustMADModel",
    "SpectralResidualModel",
]
