"""The raw cost volume's routing and the cost kernel's wrapper, on the CPU.

``cost.cost_volume`` builds CPU tensors' volumes with the plain loop over d
(``cost_kernel.reference``) and launches nothing; any other device goes to
the kernel's wrapper, which refuses what the kernel cannot take before any
launch.  A numpy model of ``cost_kernel.cu``'s schedule (its constants read
from the source) checks that every element of the volume is written once,
from the right column x + D - 1 - d, out of the staged shared memory.  The
kernel itself runs only on a card (tests/test_torch_cost_cuda.py).
"""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aswstereomatch_torch.config import PRESETS, StereoConfig
from aswstereomatch_torch.ops import cost
from aswstereomatch_torch.ops.cuda import cost_kernel

CU = Path(cost_kernel.__file__).with_suffix(".cu")


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


THREADS, TX, MAX_D, CH = (_const(n) for n in ("THREADS", "TX", "MAX_D", "CH"))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _image(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).to(torch.float32)


def _old_loop(left, right, cfg, x_extend):
    """``cost.cost_volume`` as it was before the kernel: the loop over d."""
    planes = cost.precompute(left, right, cfg, x_extend)
    return torch.stack([cost.cost_plane(planes, d, cfg) for d in range(cfg.max_disparity)],
                       dim=-1)


@pytest.mark.parametrize("shape,D,x_extend,kind", [
    ((12, 20, 3), 16, 0, "tad_grad"),
    ((9, 33, 3), 64, 4, "tad_grad"),
    ((7, 13), 5, 2, "tad_grad"),     # 2-D gray
    ((6, 11, 3), 8, 0, "ad"),
    ((5, 1, 3), 3, 16, "ad"),        # W = 1
])
def test_cpu_volumes_are_the_plain_loop_and_launch_nothing(shape, D, x_extend, kind):
    left, right = _image(shape, 1), _image(shape, 2)
    cfg = StereoConfig(max_disparity=D, cost=kind)
    before, vols = cost_kernel.launches, cost.volumes
    vol = cost.cost_volume(left, right, cfg, x_extend=x_extend)
    assert cost_kernel.launches == before and cost.volumes == vols + 1
    assert vol.shape == (shape[0], shape[1] + 2 * x_extend, D) and vol.is_contiguous()
    assert _bits_equal(vol, _old_loop(left, right, cfg, x_extend))


def _routed_cost_settings():
    return sorted({(c.cost, c.alpha, c.tau_color, c.tau_grad) for c in PRESETS.values()})


@pytest.mark.parametrize("settings", _routed_cost_settings(), ids=str)
def test_reference_is_the_old_loop_for_every_presets_cost_settings(settings):
    kind, alpha, tau_color, tau_grad = settings
    cfg = StereoConfig(max_disparity=12, cost=kind, alpha=alpha, tau_color=tau_color,
                       tau_grad=tau_grad)
    left, right = _image((8, 21, 3), 3), _image((8, 21, 3), 4)
    for x_extend in (0, 3):
        planes = cost.precompute(left, right, cfg, x_extend)
        assert _bits_equal(cost_kernel.reference(planes, cfg),
                           _old_loop(left, right, cfg, x_extend))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _planes(H=6, Wo=9, C=3, D=4, dtype=torch.float32, **over):
    p = dict(lc=_meta((H, Wo, C), dtype), rc=_meta((H, Wo + D - 1, C), dtype),
             gl=_meta((H, Wo), dtype), gr=_meta((H, Wo + D - 1), dtype))
    p.update(over)
    return cost.CostPlanes(**p, x_extend=0)


@pytest.mark.parametrize("case,planes,D,match", [
    ("float64", _planes(dtype=torch.float64), 4, "float32"),
    ("uint8", _planes(dtype=torch.uint8), 4, "float32"),
    ("one_plane_float16", _planes(gr=_meta((6, 12), torch.float16)), 4, "float32"),
    ("d_zero", _planes(D=1), 0, r"1 <= D <= 2048"),
    ("d_too_large", _planes(D=4), MAX_D + 1, r"1 <= D <= 2048"),
    ("two_channels", _planes(C=2), 4, r"\(H, W', 3\) or \(H, W', 1\)"),
    ("four_channels", _planes(C=4), 4, r"\(H, W', 3\) or \(H, W', 1\)"),
    ("two_dim_colour", _planes(lc=_meta((6, 9))), 4, r"\(H, W', 3\) or \(H, W', 1\)"),
    ("empty", _planes(H=0), 4, r"\(H, W', 3\) or \(H, W', 1\)"),
    ("right_too_narrow", _planes(rc=_meta((6, 11, 3))), 4, "do not fit"),
    ("other_d", _planes(D=4), 5, "do not fit"),
    ("gradient_rows", _planes(gl=_meta((5, 9))), 4, "do not fit"),
    ("right_channels", _planes(rc=_meta((6, 12, 1))), 4, "do not fit"),
    ("not_contiguous", _planes(gl=_meta((9, 6)).t()), 4, "contiguous"),
    ("column_slice", cost.CostPlanes(*(torch.zeros(s)[:, ::2] for s in
                                       ((6, 18, 3), (6, 24, 3), (6, 18), (6, 24))), 0),
     4, "contiguous"),
    ("devices_differ", _planes(gl=torch.zeros((6, 9))), 4, "different devices"),
    ("cpu", cost.CostPlanes(torch.zeros((6, 9, 3)), torch.zeros((6, 12, 3)),
                            torch.zeros((6, 9)), torch.zeros((6, 12)), 0), 4,
     "no cost kernel for device cpu"),
    ("meta", _planes(), 4, "no cost kernel for device meta"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case, planes, D, match):
    # the fields the wrapper reads: StereoConfig itself refuses D < 1
    cfg = SimpleNamespace(max_disparity=D, cost="tad_grad", alpha=0.9, tau_color=40.0,
                          tau_grad=10.0)
    before = cost_kernel.launches
    with pytest.raises(ValueError, match=match):
        cost_kernel.cost_volume(planes, cfg)
    assert cost_kernel.launches == before


def test_volumes_off_the_cpu_go_to_the_kernel_and_raise_without_one():
    """A device that is neither CPU nor CUDA reaches the wrapper, which
    raises rather than build the plain loop there; the volume still counts."""
    img = _meta((6, 9, 3))
    before, vols = cost_kernel.launches, cost.volumes
    with pytest.raises(ValueError, match="no cost kernel for device meta"):
        cost.cost_volume(img, img, StereoConfig(max_disparity=8), x_extend=2)
    assert cost_kernel.launches == before and cost.volumes == vols + 1


@pytest.mark.parametrize("n_out,c,want", [
    (375 * 1242, 3, np.float32(1 / 3)), (7 * 13, 3, np.float32(1 / 3)),
    (375 * 1242, 1, np.float32(1.0)), (2000 * 3000, 3, np.float32(1 / 3)),
])
def test_the_mean_factor_is_the_float32_quotient(n_out, c, want):
    f = cost_kernel.mean_factor(n_out, n_out * c)
    assert np.float32(f) == want and float(np.float32(f)) == f


# ---- a numpy model of cost_kernel.cu's schedule ------------------------

def _kernel_cost(C, cfg, l, r):
    """cost_kernel.cu's ``cost_of`` in numpy float32, in its order."""
    f32 = np.float32
    a0 = np.abs(l[0] - r[0])
    ad = a0
    if C == 3:
        ad = ((a0 + np.abs(l[2] - r[2])) + np.abs(l[1] - r[1])) * f32(1 / 3)
    if cfg.cost == "ad":
        return ad
    tc = np.where(ad > f32(cfg.tau_color), f32(cfg.tau_color), ad)
    gabs = np.abs(l[3] - r[3])
    tg = np.where(gabs > f32(cfg.tau_grad), f32(cfg.tau_grad), gabs)
    return f32(cfg.alpha) * tc + f32(1.0 - cfg.alpha) * tg


def _model(planes, cfg):
    """Run the kernel's blocks and threads over numpy copies of the planes:
    (volume, writes per element, the largest bank conflict of a warp's
    right-tile read at one k)."""
    lc, rc, gl, gr = (t.numpy() for t in planes[:4])
    H, Wo, C = lc.shape
    D = cfg.max_disparity
    vec = 4 if D % 4 == 0 else 1
    tiles = math.ceil(Wo / TX)
    rpitch = math.ceil((TX + D - 1) / vec)
    assert 4 * CH * (TX + vec * rpitch) <= 48 * 1024
    cplane = vec * rpitch
    out = np.full((H, Wo, D), np.nan, np.float32)
    writes = np.zeros((H, Wo, D), np.int64)
    worst = 1
    for b in range(H * tiles):
        y, x0 = b // tiles, (b % tiles) * TX
        nx = min(TX, Wo - x0)
        nr = nx + D - 1
        sl = np.full(CH * TX, np.nan, np.float32)
        sr = np.full(CH * cplane, np.nan, np.float32)
        lrow, rrow = lc[y].ravel()[x0 * C:], rc[y].ravel()[x0 * C:]
        for i in range(nx * C):
            j = i // 3 if C == 3 else i
            sl[(i - C * j) * TX + j] = lrow[i]
        for i in range(nr * C):
            j = i // 3 if C == 3 else i
            sr[(i - C * j) * cplane + (j % vec) * rpitch + j // vec] = rrow[i]
        sl[3 * TX: 3 * TX + nx] = gl[y, x0: x0 + nx]
        for j in range(nr):
            sr[3 * cplane + (j % vec) * rpitch + j // vec] = gr[y, x0 + j]
        G = D // vec
        step_x, step_g = THREADS // G, THREADS % G
        t = np.arange(THREADS)
        x, g = t // G, t % G
        channels = (0, 1, 2, 3) if C == 3 else (0, 3)
        while (x < nx).any():
            live = x < nx
            xs, gs = x[live], g[live]
            l = [sl[c * TX + xs] for c in range(CH)]
            for k in range(vec):
                d = vec * gs + k
                j = xs + D - 1 - d
                assert (0 <= j).all() and (j < nr).all()
                at = (j % vec) * rpitch + j // vec
                r = [sr[c * cplane + at] for c in range(CH)]
                assert not any(np.isnan(v).any() for c in channels for v in (l[c], r[c]))
                out[y, x0 + xs, d] = _kernel_cost(C, cfg, l, r)
                writes[y, x0 + xs, d] += 1
                lanes = t[live]
                for w in np.unique(lanes // 32):
                    banks = at[lanes // 32 == w] % 32
                    words = at[lanes // 32 == w]
                    worst = max(worst, max(len(np.unique(words[banks == bk]))
                                           for bk in np.unique(banks)))
            x, g = x + step_x, g + step_g
            wrap = g >= G
            g[wrap] -= G
            x[wrap] += 1
    return out, writes, worst


@pytest.mark.parametrize("shape,D,x_extend,kind", [
    ((2, 70, 3), 128, 0, "tad_grad"),    # the cell's D, a ragged second tile
    ((2, 130, 3), 64, 16, "tad_grad"),   # two pixels a warp
    ((3, 9, 3), 5, 0, "tad_grad"),       # D not a multiple of 4
    ((2, 40), 12, 3, "ad"),              # gray
    ((2, 5, 3), 1, 0, "tad_grad"),       # D = 1
    ((1, 3, 3), 300, 0, "ad"),           # D above the threads of a block
])
def test_the_kernels_schedule_writes_each_element_once_from_its_columns(shape, D, x_extend,
                                                                        kind):
    cfg = StereoConfig(max_disparity=D, cost=kind)
    left, right = _image(shape, D), _image(shape, D + 1)
    planes = cost.precompute(left, right, cfg, x_extend)
    vol, writes, worst = _model(planes, cfg)
    assert (writes == 1).all()
    want = cost_kernel.reference(planes, cfg).numpy()
    np.testing.assert_allclose(vol, want, rtol=1e-6, atol=1e-6)
    if D == 128:  # a warp reads 32 consecutive words of one sub-plane
        assert worst == 1


def test_the_wrappers_bound_on_d_is_the_kernels():
    assert cost_kernel.MAX_D == MAX_D
    assert 4 * CH * (TX + 4 * math.ceil((TX + MAX_D - 1) / 4)) <= 48 * 1024
    assert 4 * CH * (TX + (TX + MAX_D - 1)) <= 48 * 1024
