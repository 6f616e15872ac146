"""The least time some work can take on the card: the larger of its bytes
over the HBM bandwidth and each 32-bit integer pipe's instructions over
that pipe's issue rate, with the peaks of `peaks.json`. The counts of a
kernel's work are frozen beside it (`f4.json`), so that the yardstick reads
the same work whatever implements it."""

from __future__ import annotations

import json
import os
from typing import Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, f"{name}.json")) as fh:
        return json.load(fh)


def least_seconds(nbytes: float, alu: float, fma: float,
                  peaks: dict = None) -> Tuple[float, str]:
    """(seconds, what bounds it: "bytes" or "operations")."""
    peaks = peaks or load("peaks")
    pipe = (peaks["sms"] * peaks["int32_lanes_per_sm_per_pipe"]
            * peaks["boost_clock_hz"])
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = max(alu, fma) / pipe
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def f4_call_bytes(n: int, streamed: bool, counts: dict = None) -> int:
    """Bytes of one F4 call over n positions, by `f4.json`'s rule."""
    c = counts or load("f4")
    mode = "streamed" if streamed else "resident"
    tile, mid = c["table_tile"], c["table_mid"]
    return (c["acc_per_position"] * n
            + 8 * c["input_words_per_position"][mode] * n
            + c["input_bytes_per_call"][mode]
            + c["weight_bytes_per_call"]
            + 16 * c["distinct_shifts"] * (tile + mid + -(-n // (tile * mid))))


def f4_least_seconds(domain: int, classes: int) -> Tuple[float, str]:
    """The least time of a prove's F4 work: one call over the whole FRI
    domain resident, or one a class of domain / classes positions."""
    c = load("f4")
    streamed = classes > 1
    n = domain // classes
    nbytes = classes * f4_call_bytes(n, streamed, c)
    return least_seconds(nbytes, c["alu_per_position"] * domain,
                         c["fma_per_position"] * domain)
