"""Misc helpers.

Port of cslam_tpu/utils/misc.py (pure Python, copied so that the port
imports nothing of the reference package).
"""

from typing import Dict, List


def clamp(value, low, high):
    """Clamp value into [low, high]."""
    return max(low, min(value, high))


def dict_to_list_chunks(d: Dict, start_idx: int, chunk_size: int) -> List[list]:
    """Values of a key-sorted dict from start_idx onward, in chunks
    (used to batch gossip publications)."""
    values = [d[k] for k in sorted(d.keys())]
    values = values[max(start_idx, 0):]
    return [values[i:i + chunk_size]
            for i in range(0, len(values), chunk_size)]
