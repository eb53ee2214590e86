from .device import HBM_GBPS, card_line, hbm_gbps, require_device

__all__ = ["HBM_GBPS", "card_line", "hbm_gbps", "require_device"]
