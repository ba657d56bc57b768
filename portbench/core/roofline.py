"""The yardstick of the kernels: published peaks of the card, and the bytes
a rejection stack has to move, counted from shapes.

A rejection stack of F frames over P pixels reads each uint16 input word
once and writes each uint16 output word once, whatever implements it;
its least time is those bytes at the card's memory rate. (No arithmetic
bound: sorting and clipping a column is a few hundred operations a word,
far under the card's float32 rate a byte.)
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet: HBM3 bytes a second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def stack_bytes(f: int, p: int) -> int:
    """Bytes a rejection stack of (F, P) uint16 words into (P,) uint16
    moves at the least."""
    return 2 * f * p + 2 * p


def share_pct(nbytes: float, seconds: float, card: str = DEFAULT_CARD) -> float:
    """The share, in %, of the card's memory roofline that moving ``nbytes``
    in ``seconds`` reaches."""
    peak = PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]
    return 100.0 * nbytes / (seconds * peak)


__all__ = ["PEAKS", "stack_bytes", "share_pct", "stack_share_pct"]


def stack_share_pct(run, rejection: str):
    """The share of the memory roofline that a traced run's
    ``stack_rejected`` calls with ``rejection`` reached: their bytes over
    their summed CUDA-event time. None where there were none, or no device
    times."""
    if run.spans is None:
        return None
    nbytes = seconds = 0.0
    for span in run.spans.clean(run.spans.records.get("stack_rejected", [])):
        shape, kind = span.args[0], span.args[1]
        ms = span.device_ms()
        if kind != rejection or ms is None or not isinstance(shape, tuple):
            continue
        nbytes += stack_bytes(*shape)
        seconds += ms * 1e-3
    return share_pct(nbytes, seconds, run.card) if seconds > 0 else None
