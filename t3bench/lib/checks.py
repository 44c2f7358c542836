"""The numbers that decide ``correct``, each beside its limit."""
from __future__ import annotations

import torch


def wrong(got: torch.Tensor, want: torch.Tensor) -> int:
    """Symbols of ``got`` that differ from ``want``; every one when the
    shapes differ."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want.to(got.device, got.dtype)).sum())


def at_most(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit, "op": "<="}


def at_least(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit, "op": ">="}


def passed(c: dict) -> bool:
    return c["value"] <= c["limit"] if c["op"] == "<=" \
        else c["value"] >= c["limit"]
