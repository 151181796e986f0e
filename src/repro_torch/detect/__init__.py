"""Detection plane (port of `repro/detect/`): so far the shape buckets that
the streaming detector pads its kernel inputs to. The async executor, the
sweep guard and the detector families come with later slices."""
from repro_torch.detect.cache import (MIN_BUCKET, SHAPE_CACHE,  # noqa: F401
                                      ShapeBucketCache, bucket_rows,
                                      pad_to_bucket)
