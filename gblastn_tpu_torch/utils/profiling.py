"""Stage timing + hit-count diagnostics.

The analog of G-BLASTN's CLogFile singleton ``slogfile`` (reference:
NCBI c++/include/algo/blast/gpu_blast/gpu_logfile.h:13-97 —
wall timers, named accumulator maps, per-job step dumps written to
``<query>.log``) combined with the engine's BlastDiagnostics hit-count
structs (core/blast_diagnostics.c). On TPU the per-kernel CUDA event
timers become host-side wall timing around blocking device calls.
The port's copy of ``gblastn_tpu/utils/profiling.py``, without its
``jax.profiler`` trace hook.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Diagnostics:
    """Seeding/extension hit counts (BlastUngappedStats/BlastGappedStats)."""

    lookup_hits: int = 0        # raw scan seed hits
    init_extends: int = 0       # seeds surviving mini-extension
    good_init_extends: int = 0  # ungapped extensions above cutoff
    gapped_extensions: int = 0  # prelim gapped extensions attempted
    device_gapped_rejects: int = 0  # extensions screened out on device
    good_gapped: int = 0        # prelim HSPs above cutoff
    final_hsps: int = 0         # HSPs after traceback + filtering
    replay_fallbacks: int = 0   # device-replay batches escalated to host

    def merge(self, other: "Diagnostics") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))


@dataclass
class StageLog:
    """Named accumulator timers (CLogFile::addTotalTime analog)."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    values: dict[str, float] = field(default_factory=dict)
    diagnostics: Diagnostics = field(default_factory=Diagnostics)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_value(self, name: str, value: float) -> None:
        self.values[name] = self.values.get(name, 0.0) + value

    def report(self) -> str:
        lines = ["== gblastn_tpu stage report =="]
        for name in sorted(self.totals):
            lines.append(
                f"{name:<32s} {self.totals[name]*1000:12.2f} ms"
                f"  ({self.counts[name]} calls)"
            )
        for name in sorted(self.values):
            lines.append(f"{name:<32s} {self.values[name]:12.0f}")
        d = self.diagnostics
        lines.append(
            f"{'lookup hits':<32s} {d.lookup_hits:12d}\n"
            f"{'seeds after mini-ext':<32s} {d.init_extends:12d}\n"
            f"{'ungapped above cutoff':<32s} {d.good_init_extends:12d}\n"
            f"{'gapped extensions':<32s} {d.gapped_extensions:12d}\n"
            f"{'device gapped rejects':<32s} {d.device_gapped_rejects:12d}\n"
            f"{'prelim HSPs':<32s} {d.good_gapped:12d}\n"
            f"{'final HSPs':<32s} {d.final_hsps:12d}"
        )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.values.clear()
        self.diagnostics = Diagnostics()


# process-wide log (the slogfile singleton role); cheap when unused
slog = StageLog()

