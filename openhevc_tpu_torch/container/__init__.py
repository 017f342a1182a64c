from .mp4 import demux_mp4, mux_mp4, is_mp4  # noqa: F401
from .ts import demux_ts, mux_ts, is_ts      # noqa: F401
from .mkv import demux_mkv, mux_mkv, is_mkv  # noqa: F401
from .ogg import demux_ogg, mux_ogg, is_ogg  # noqa: F401
