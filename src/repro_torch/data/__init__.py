from .pipeline import anomaly_dataset, lm_batches
from .video import VideoSpec, generate_video, motion_level_spec

__all__ = ["VideoSpec", "anomaly_dataset", "generate_video", "lm_batches",
           "motion_level_spec"]
