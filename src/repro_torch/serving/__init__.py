from .api import (
    AttentionPrefill, CodecFrontend, CodecStream, DecodedWindows, DecodePending,
    EncodedWindows, GreedyDecoder, MODES, PRUNE_MODES, PrefilledWindows, PrefillResult,
    RecurrentPrefill, REUSE_MODES, NO, QUERY_IDS, ServingPipeline, StageTimer,
    StreamRequest, StreamSession, VisualEncoder, WindowResult, WindowStats, YES,
    resolve_device,
)
from .config import EngineCfg, KVCfg, PruneCfg, RefreshCfg, SchedulerCfg
from .engine import Engine
from .events import (
    EventProtocolError, EventProtocolValidator, SchedulerError, SchedulerEvent,
    StreamAdmitted, StreamDone, StreamThrottled, WindowDone,
)
from .metrics import agreement, precision_recall_f1, video_prediction
from .scheduler import Scheduler
from . import flops

__all__ = [
    "EngineCfg", "KVCfg", "PruneCfg", "RefreshCfg", "SchedulerCfg",
    "ServingPipeline", "Scheduler", "StreamRequest", "StreamSession",
    "WindowResult", "WindowStats", "MODES", "PRUNE_MODES", "REUSE_MODES", "QUERY_IDS", "YES", "NO",
    "SchedulerEvent", "StreamAdmitted", "StreamThrottled", "WindowDone",
    "StreamDone", "SchedulerError", "EventProtocolError", "EventProtocolValidator",
    "Engine",
    "CodecFrontend", "CodecStream", "VisualEncoder", "AttentionPrefill",
    "RecurrentPrefill", "GreedyDecoder", "PrefillResult", "DecodePending",
    "EncodedWindows", "PrefilledWindows", "DecodedWindows", "StageTimer",
    "resolve_device",
    "precision_recall_f1", "video_prediction", "agreement", "flops",
]
