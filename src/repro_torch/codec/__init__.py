from .metadata import Bitstream, CodecMetadata, I_FRAME, P_FRAME, gop_frame_types
from .encoder import encode_stream, motion_compensate
from .decoder import decode_stream, StreamDecoder

__all__ = [
    "Bitstream", "CodecMetadata", "I_FRAME", "P_FRAME", "gop_frame_types",
    "encode_stream", "motion_compensate", "decode_stream", "StreamDecoder",
]
