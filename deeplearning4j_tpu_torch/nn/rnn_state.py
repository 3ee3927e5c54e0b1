"""Stateful-inference bookkeeping (counterpart of
`deeplearning4j_tpu/nn/rnn_state.py`): the merge/split rules for the
UNDECLARED layer state that `rnn_time_step` and the decode steppers carry
(attention KV caches, positional cursors), and the decode-capacity guard."""

from __future__ import annotations

from typing import Dict, Optional


def merge_rnn_state(base_state: Dict, rnn_state: Dict) -> Dict:
    """Overlay carried rnn state on the persistent (declared) state."""
    state = dict(base_state)
    for key, s in rnn_state.items():
        merged = dict(state.get(key, {}))
        merged.update(s)
        state[key] = merged
    return state


def split_rnn_state(new_state: Dict, declared: Dict) -> Dict:
    """Keep only the undeclared entries (the rnn carries) of a forward's
    returned state."""
    out = {key: {k: v for k, v in s.items() if k not in declared.get(key, ())}
           for key, s in new_state.items()}
    return {key: s for key, s in out.items() if s}


def decode_capacity(layers) -> Optional[int]:
    """Smallest decode_cache_length across attention layers (None when no
    layer carries a KV cache)."""
    caps = [l.decode_cache_length for l in layers
            if getattr(l, "decode_cache_length", None)]
    return min(caps) if caps else None


def refuse_tbptt_with_cache(layers) -> None:
    """Truncated BPTT carries undeclared layer state across chunks; with an
    attention KV cache that state would thread into training, so both
    engines refuse it, as the reference's do."""
    if decode_capacity(layers) is not None:
        raise ValueError(
            "truncated BPTT carries undeclared layer state across "
            "chunks, which would thread attention KV caches into "
            "training; unset decode_cache_length (it is an inference "
            "feature) or use standard backprop")


def check_decode_budget(pos: int, t: int, capacity: Optional[int]) -> int:
    """Refuse a stateful step past the cache capacity; returns the new
    position."""
    if capacity is not None and pos + t > capacity:
        raise ValueError(
            f"stateful decode overflow: position {pos} + {t} new steps "
            f"exceeds the decode cache capacity {capacity}; call "
            "rnn_clear_previous_state() to start a new sequence")
    return pos + t
