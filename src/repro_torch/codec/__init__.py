from .metadata import Bitstream, CodecMetadata, I_FRAME, P_FRAME, gop_frame_types
from .encoder import encode_stream, estimate_bits, motion_compensate
from .decoder import decode_stream, NaiveDecoder, StreamDecoder

__all__ = [
    "Bitstream", "CodecMetadata", "I_FRAME", "P_FRAME", "gop_frame_types",
    "encode_stream", "estimate_bits", "motion_compensate", "decode_stream",
    "NaiveDecoder", "StreamDecoder",
]
