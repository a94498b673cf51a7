"""What one run knows, handed to the drivers and to each per-layer
metric's reader."""

from __future__ import annotations

import dataclasses
from typing import Any

from .manifest import Cell
from .peaks import Peaks
from .trace import OpRanges, TraceResult


@dataclasses.dataclass
class RunContext:
    cell: Cell
    model: dict                     # model_of(cell.config)
    settings: dict                  # the path's settings (config + traffic)
    device: Any                     # "cuda" or, in CPU rehearsals, "cpu"
    peaks: Peaks
    seed: int
    seconds: float
    trace: bool
    ranges: OpRanges | None = None  # the harness's profiler ranges
    engine_hooks: list = dataclasses.field(default_factory=list)
    in_window: bool = False         # set by the driver at open and close
    counts: dict = dataclasses.field(default_factory=dict)
    window: dict = dataclasses.field(default_factory=dict)
    program: dict = dataclasses.field(default_factory=dict)
    traced: TraceResult | None = None
    memory_peak_bytes: int | None = None

    @property
    def on_card(self) -> bool:
        return str(self.device).startswith("cuda")
