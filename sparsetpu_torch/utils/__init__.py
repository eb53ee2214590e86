from .config import (DEFAULT_BLOCK_COLS, DEFAULT_CONFIG, LANES,
                     MAX_BLOCK_COLS, SUBLANES, SpmvConfig, TILE)
from .device import (CUDA, HBM_GBPS, card_line, hbm_gbps, pick_device,
                     require_device)
from .timing import PhaseTimer, get_timestamp, maybe_profiler_trace

__all__ = [
    "DEFAULT_BLOCK_COLS", "DEFAULT_CONFIG", "LANES", "MAX_BLOCK_COLS",
    "SUBLANES", "SpmvConfig", "TILE", "PhaseTimer", "get_timestamp",
    "maybe_profiler_trace", "CUDA", "HBM_GBPS", "card_line", "hbm_gbps",
    "pick_device", "require_device",
]
