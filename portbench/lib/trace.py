"""The profiled tail of a traced run, reduced to what the readers need.

``profile(fn, steps)`` runs ``fn`` (the tail: a few more steps or batches
through the window's own call) under ``torch.profiler`` and returns a
:class:`Trace`: every device kernel as ``(name, start_us, end_us)`` and the
host's operations, for idle gaps. Busy time is the union of the kernels'
intervals; the span runs from the first kernel's start to the last one's
end, so idle time is span minus busy.

A kernel table maps device kernel names to what they compute: an ordered
list of ``(substring, label)``, matched lower-case, first hit wins; a name
no entry matches is ``"other"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

Table = Sequence[Tuple[str, str]]

# device kernels by family, for the breakdown (the readers keep their own
# tables); the hand-written kernels by their entry names, then the library
GROUPS: Table = (
    ("long_bwd_rows_mma", "K5b rows"), ("long_bwd_keys_mma", "K5b keys"),
    ("long_attention_q_mma", "K6a attention"), ("long_attention_mma", "K5a attention"),
    ("gemm_resid_ln", "K2c int8 GEMM + residual + LN"),
    ("int8_wgmma_kernel<1,", "K2b int8 GEMM + GELU"), ("int8_wgmma_kernel", "K2a int8 GEMM"),
    ("quantize_gemm", "K7 quantize + int8 GEMM"), ("ln_quantize", "K2d LN + quantize"),
    ("attention_bwd_rows", "kernel B rows"), ("attention_bwd_keys", "kernel B keys"),
    ("attention_q_mma", "K3 / kernel A attention"), ("attention_f32", "f32 attention"),
    ("megablock", "K9 block"),
    ("nccl", "NCCL collectives"),
    ("flash", "library attention"), ("fmha", "library attention"), ("sdpa", "library attention"),
    ("gemm", "library GEMM"), ("nvjet", "library GEMM"), ("cutlass", "library GEMM"),
    ("xmma", "library GEMM"), ("sm90_", "library GEMM"), ("int_mm", "library GEMM"),
    ("multi_tensor_apply", "optimizer (foreach)"), ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("copy", "copies"), ("memcpy", "copies"),
    ("memset", "copies"),
)


def label(name: str, table: Table) -> str:
    n = name.lower()
    for key, lab in table:
        if key in n:
            return lab
    return "other"


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]  # device kernels: name, start, end (us)
    host_ops: List[Tuple[str, float, float]]  # host operations: name, start, end (us)
    steps: int  # steps or batches profiled

    @property
    def span_us(self) -> float:
        if not self.kernels:
            return 0.0
        return max(e for _, _, e in self.kernels) - min(s for _, s, _ in self.kernels)

    @property
    def busy_us(self) -> float:
        busy, end = 0.0, None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def by_label(self, table: Table) -> Dict[str, float]:
        """Device microseconds by the table's labels (summed durations)."""
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            lab = label(name, table)
            out[lab] = out.get(lab, 0.0) + (e - s)
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals between the kernels' union, longest first."""
        out, end = [], None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` (or "host idle")."""
        best = None
        for name, s, e in self.host_ops:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "host idle"

    def breakdown(self, top: int = 10):
        """``{"device_ops": [[group, s]], "idle_gaps": [[host op, s]]}``."""
        ops = sorted(self.by_label(GROUPS).items(), key=lambda kv: -kv[1])[:top]
        gaps = [[self.host_op_at((s + e) / 2), (e - s) / 1e6] for s, e in self.gaps()[:top]]
        return {"device_ops": [[k, v / 1e6] for k, v in ops], "idle_gaps": gaps}


def profile(torch, fn: Callable[[], None], steps: int) -> Trace:
    """``fn()`` under torch.profiler, ending in a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, host = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            continue  # a host range drawn on the device's timeline, not work
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, float(tr.start), float(tr.end)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    return Trace(kernels, host, steps)
