"""Semi-global aggregation (``aggregation="sgm"``): wrapper and plain version.

Counterpart of the reference's ``aggregate_sgm`` (``aswstereomatch_tpu/ops/
aggregate.py``), which runs its scans as XLA ``lax.scan``s, not Pallas.  The
kernel is hand-written CUDA (``sgm_kernel.cu``, bound as
``torch.ops.asw_torch.sgm_aggregate`` by ``asw_binding.cpp``, built by
``build.py``).  It runs the directions in phases, one launch each: in each
group of four directions of the pinned order, the first three side by side
(the first writes S, or adds into it, the other two write their L into two
scratch volumes), then the fourth, which completes S as ((S + X1) + X2) + L.
One warp runs one scanline; at D <= 128 and a multiple of 4 each lane
keeps its four disparities' L in registers, and the costs (and S and the
scratch volumes in a completing phase) are staged eight steps ahead into a
per-warp ring in shared memory; any other D takes the long-D path, whose L
rows lie in shared or global memory.  ``plan`` computes the phases, their
work tables, the ring's shared memory and the scratch; the CPU tests check
it, and a numpy model of the schedule, against the plain version.

The recurrence, per path direction r with predecessor q = p - r (pinned in
the reference's config.py):

    L_r(p, d) = (C(p, d) + min(L_r(q, d), L_r(q, d-1) + P1,
                               L_r(q, d+1) + P1, min_d' L_r(q, d') + P2))
                - min_d' L_r(q, d')

with L_r = C where p has no in-image predecessor and out-of-range d+-1
terms +inf.  S sums l2r, r2l, t2b, b2t in that order, then for 8 paths
(1,1), (1,-1), (-1,1), (-1,-1).  Each step is adds and mins only, so the
order of the path sum fixes every bit: the kernel equals the plain version
(and the reference) bit for bit, on either path.

On a CUDA tensor ``aggregate`` launches the kernel (and raises if it
cannot); on a CPU tensor it computes the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import StereoConfig
from . import build
from .common import f32

# Kernel launches since the last reset (chip_smoke.py reads this to show
# that the main path went through the kernel).  One per aggregated volume;
# ``long_launches`` counts those of them whose phases ran the long-D path.
launches = 0
long_launches = 0

# The directions in the pinned summation order, as (dy, dx): the step from
# a pixel to the next one on its scanline (the predecessor is p - (dy, dx)).
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))

# What a direction writes in its phase (sgm_kernel.cu's Role): S = L, X1 = L,
# X2 = L, S = S + L, S = ((S + X1) + X2) + L.
WRITE_S, WRITE_X1, WRITE_X2, ADD_S, COMPLETE_S = range(5)
# Volumes one step of each role reads: C, then S, X1, X2 (it writes one).
ROLE_VOLUMES = (1, 1, 1, 2, 4)

VPL = 4                       # disparities a lane holds on the register path
REG_MAX_D = 32 * VPL          # the register path's largest D
SMEM_OPTIN = 232_448          # shared memory an H100 block may opt in to
ROW_SMEM_BUDGET = 48 * 1024   # the long-D path's two L rows a warp, in shared memory
DEPTH = 8                     # the register path's ring depth, steps
WARPS = 4                     # warps (scanlines) per block


class Slot(NamedTuple):
    """One direction of a phase: its step (dy, dx), role and scanlines."""
    dy: int
    dx: int
    role: int
    n_lines: int


class PhasePlan(NamedTuple):
    """One launch: its slots in hand-out order (warp g takes line g -
    first[j] of slot j), the volumes a ring slot holds and the block's
    dynamic shared memory."""
    slots: tuple
    nvol: int
    smem_bytes: int


class Plan(NamedTuple):
    """The kernel's schedule.  ``vpl``: disparities per lane on the register
    path (VPL), 0 for the long-D path; ``scratch_volumes`` (H, W, D)
    float32 volumes and ``row_floats`` floats of global L rows (the long-D
    path past ROW_SMEM_BUDGET), which the wrapper allocates."""
    vpl: int
    scratch_volumes: int
    row_floats: int
    phases: tuple

    def ints(self) -> list:
        """The flat form the binding takes (sgm_kernel.cu's plan layout)."""
        out = [self.vpl, self.scratch_volumes, self.row_floats, len(self.phases)]
        for ph in self.phases:
            out += [len(ph.slots), ph.nvol, ph.smem_bytes]
            for k in range(3):
                out += list(ph.slots[k]) if k < len(ph.slots) else [0, 0, 0, 0]
        return out

    def scratch_floats(self, H: int, W: int, D: int) -> int:
        return self.scratch_volumes * H * W * D + self.row_floats

    def volumes_moved(self) -> int:
        """(H, W, D) volumes read and written: 3 P - 1 for P paths."""
        return sum(ROLE_VOLUMES[s.role] + 1 for ph in self.phases for s in ph.slots)


def lines_of(H: int, W: int, dy: int, dx: int) -> int:
    """Scanlines of direction (dy, dx): rows, columns or H + W - 1 diagonals."""
    return H if dy == 0 else (W if dx == 0 else H + W - 1)


def longest_line(H: int, W: int, dy: int, dx: int) -> int:
    return W if dy == 0 else (H if dx == 0 else min(H, W))


def schedule(paths: int) -> tuple:
    """The phases as ((direction index, role), ...): in each group of four
    directions of the pinned order the first three side by side, the first
    of them writing S (adding into it after the first group), then the
    fourth completing S."""
    out = []
    for g in range(0, paths, 4):
        out.append(((g, ADD_S if g else WRITE_S), (g + 1, WRITE_X1), (g + 2, WRITE_X2)))
        out.append(((g + 3, COMPLETE_S),))
    return tuple(out)


def plan(H: int, W: int, D: int, paths: int, *, vpl: int | None = None) -> Plan:
    """The kernel's plan for an (H, W, D) volume and 4 or 8 paths.  Each
    phase's slots go longest scanlines first.  On the register path (D <=
    REG_MAX_D and a multiple of VPL) a ring slot holds the most volumes a
    slot of the phase reads, DEPTH steps of them.  The long-D path (any
    other D, or ``vpl=0`` at any D) keeps its L rows in shared memory while
    2 (D + 2) floats a warp fit ROW_SMEM_BUDGET, else in global rows after
    the scratch volumes."""
    if paths not in (4, 8):
        raise ValueError("sgm_paths must be 4 or 8")
    if vpl is None:
        vpl = VPL if D <= REG_MAX_D and D % VPL == 0 else 0
    if vpl not in (0, VPL) or (vpl and (D > REG_MAX_D or D % VPL)):
        raise ValueError(f"the register path takes D <= {REG_MAX_D}, a multiple of {VPL}")
    row_bytes = 4 * 2 * (D + 2)
    rows_global = not vpl and row_bytes > ROW_SMEM_BUDGET
    phases, most_lines = [], 0
    for group in schedule(paths):
        slots = [Slot(*DIRECTIONS[j], role, lines_of(H, W, *DIRECTIONS[j])) for j, role in group]
        slots.sort(key=lambda s: -longest_line(H, W, s.dy, s.dx))
        nvol = max(ROLE_VOLUMES[s.role] for s in slots)
        most_lines = max(most_lines, sum(s.n_lines for s in slots))
        if vpl:
            smem = WARPS * DEPTH * nvol * 32 * vpl * 4
        else:
            smem = 0 if rows_global else WARPS * row_bytes
        phases.append(PhasePlan(tuple(slots), nvol, smem))
    row_floats = most_lines * 2 * (D + 2) if rows_global else 0
    return Plan(vpl, 2, row_floats, tuple(phases))


def _check_plan(p: Plan, H: int, W: int, D: int, paths: int) -> None:
    """Raise unless ``p`` runs each direction of ``paths`` once over (H, W,
    D), in the phases and roles of ``schedule``, with two scratch volumes:
    a plan that does not sum every path in the pinned order is no SGM."""
    got = [sorted((s.dy, s.dx, s.role, s.n_lines) for s in ph.slots) for ph in p.phases]
    want = [sorted((*DIRECTIONS[j], role, lines_of(H, W, *DIRECTIONS[j])) for j, role in group)
            for group in schedule(paths)]
    if got != want or p.scratch_volumes != 2:
        raise ValueError(f"the plan does not run the {paths}-path schedule over "
                         f"({H}, {W}, {D}): {got}")


def _check(vol: torch.Tensor, cfg: StereoConfig) -> None:
    if vol.dtype != torch.float32 or vol.ndim != 3 or not vol.is_contiguous():
        raise ValueError(
            "sgm aggregation takes a contiguous float32 (H, W, D) cost volume, "
            f"got {vol.dtype} {tuple(vol.shape)}"
        )
    if vol.shape[2] != cfg.max_disparity:
        raise ValueError(
            f"cost volume has {vol.shape[2]} disparities, config says {cfg.max_disparity}"
        )
    if cfg.sgm_paths not in (4, 8):
        raise ValueError("sgm_paths must be 4 or 8")


def _best(ps: torch.Tensor, pmin: torch.Tensor, p1: torch.Tensor,
          p2: torch.Tensor) -> torch.Tensor:
    """min(L(q, d), min(L(q, d-1), L(q, d+1)) + P1, pmin + P2) over the
    previous step's (lines, D) plane ``ps``, +inf past either end of d."""
    inf = torch.full_like(ps[..., :1], float("inf"))
    up = torch.cat([inf, ps[..., :-1]], dim=-1)  # L(q, d-1)
    dn = torch.cat([ps[..., 1:], inf], dim=-1)   # L(q, d+1)
    return torch.minimum(torch.minimum(ps, pmin + p2), torch.minimum(up, dn) + p1)


def _penalties(cfg: StereoConfig, device) -> tuple:
    return (torch.tensor(f32(cfg.sgm_p1), dtype=torch.float32, device=device),
            torch.tensor(f32(cfg.sgm_p2), dtype=torch.float32, device=device))


def _sgm_scan(vol: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """One directional pass along axis 0 of ``vol`` (N, M, D): the
    reference's ``_sgm_scan``, its ``lax.scan`` a Python loop carrying the
    previous step's (M, D) plane.  The first step is C."""
    out = [vol[0]]
    prev = vol[0]
    for i in range(1, vol.shape[0]):
        pmin = torch.amin(prev, dim=-1, keepdim=True)
        prev = (vol[i] + _best(prev, pmin, p1, p2)) - pmin
        out.append(prev)
    return torch.stack(out)


def _sgm_scan_diag(vol2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   w: int) -> torch.Tensor:
    """The reference's packed diagonal pass along axis 0 of ``vol2`` (N, 2W,
    D): the predecessor shifts +1 column per step for the first W columns
    and -1 for the last W; a column with no in-image predecessor takes
    L = C (its +inf predecessor makes pmin non-finite)."""
    inf = torch.full((1, vol2.shape[-1]), float("inf"), dtype=vol2.dtype, device=vol2.device)
    out = [vol2[0]]
    prev = vol2[0]
    for i in range(1, vol2.shape[0]):
        a = torch.cat([inf, prev[:w][:-1]], dim=0)
        b = torch.cat([prev[w:][1:], inf], dim=0)
        ps = torch.cat([a, b], dim=0)
        pmin = torch.amin(ps, dim=-1, keepdim=True)
        c = vol2[i]
        prev = torch.where(torch.isfinite(pmin), (c + _best(ps, pmin, p1, p2)) - pmin, c)
        out.append(prev)
    return torch.stack(out)


def aggregate_reference(vol: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """Plain PyTorch version on any device: the reference's
    ``aggregate_sgm``, line for line (the opposed directions of each axis
    packed into one scan, the path sum in the pinned order)."""
    _check(vol, cfg)
    p1, p2 = _penalties(cfg, vol.device)
    h, w, _ = vol.shape
    volx = vol.transpose(0, 1)  # (W, H, D): scan along x
    sx = _sgm_scan(torch.cat([volx, volx.flip(0)], dim=1), p1, p2)
    l2r = sx[:, :h].transpose(0, 1)
    r2l = sx.flip(0)[:, h:].transpose(0, 1)
    sy = _sgm_scan(torch.cat([vol, vol.flip(0)], dim=1), p1, p2)
    t2b = sy[:, :w]
    b2t = sy.flip(0)[:, w:]
    s = ((l2r + r2l) + t2b) + b2t
    if cfg.sgm_paths == 8:
        dvol = torch.cat([vol, vol], dim=1)
        dt = _sgm_scan_diag(dvol, p1, p2, w)
        db = _sgm_scan_diag(dvol.flip(0), p1, p2, w).flip(0)
        s = (((s + dt[:, :w]) + dt[:, w:]) + db[:, :w]) + db[:, w:]
    return s.to(torch.float32).contiguous()


def aggregate(vol: torch.Tensor, cfg: StereoConfig, plan: Plan | None = None) -> torch.Tensor:
    """Semi-global aggregation of a raw (H, W, D) float32 cost volume:
    the plain version for a CPU tensor, the kernel for a CUDA tensor; any
    other device raises.  ``plan`` overrides ``plan(...)``, e.g. to take the
    long-D path at a small D; it must run ``cfg``'s schedule (else
    ValueError), and then gives the same bits."""
    _check(vol, cfg)
    if plan is not None:
        _check_plan(plan, *vol.shape, cfg.sgm_paths)
    if vol.device.type == "cpu":
        return aggregate_reference(vol, cfg)
    if vol.device.type != "cuda":
        raise ValueError(f"no kernel for device {vol.device}")
    return _run(vol, cfg, plan or _default_plan(vol, cfg.sgm_paths))


def _default_plan(vol: torch.Tensor, paths: int) -> Plan:
    """``plan`` for ``vol``, on the long-D path where the volume is not
    16-byte aligned, as the register path's copies need."""
    return plan(*vol.shape, paths, vpl=None if vol.data_ptr() % 16 == 0 else 0)


def _run(vol: torch.Tensor, cfg: StereoConfig, p: Plan) -> torch.Tensor:
    """Launch plan ``p`` as it is, unchecked: ``aggregate`` after its checks,
    and the timings of one phase (or part of one) alone, whose sums read
    whatever S and the scratch hold (utils/plan_sweep.py, chip_smoke.py)."""
    global launches, long_launches
    build.load()
    H, W, D = vol.shape
    scratch = torch.empty(p.scratch_floats(H, W, D), dtype=torch.float32, device=vol.device)
    out = torch.ops.asw_torch.sgm_aggregate(vol, scratch, f32(cfg.sgm_p1), f32(cfg.sgm_p2),
                                            p.ints())
    launches += 1
    if not p.vpl:
        long_launches += 1
    return out
