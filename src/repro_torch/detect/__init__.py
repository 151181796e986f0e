"""Detection plane (port of `repro/detect/`): the shape buckets the
streaming detector pads its kernel inputs to, the async executor that runs
sweeps off the step thread, and the sweep guard. The detector families
(`families.py`, `isoforest.py`, `robust.py`, `spectral.py`) come with a
later slice."""
from repro_torch.detect.cache import (MIN_BUCKET, SHAPE_CACHE,  # noqa: F401
                                      ShapeBucketCache, bucket_rows,
                                      pad_to_bucket)
from repro_torch.detect.executor import DetectionExecutor, SweepResult  # noqa: F401
from repro_torch.detect.guard import detection_zone, in_detection_zone  # noqa: F401
