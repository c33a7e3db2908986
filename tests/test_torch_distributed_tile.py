"""One pair's tile axis across processes: the port's y-, x- and d-sharded
layouts, the data x tile batch and the reshard over gloo loopback groups,
in the reference's two cluster shapes (tests/test_distributed.py):

  - 2 processes x 4 CPU devices: the batch on data 2 x tile 4; x on the
    first 4 global devices, so process 1 owns no shard and sends nothing;
    d and y over all 8;
  - 4 processes x 1 device: the batch on data 2 x tile 2; x, d and y over
    all 4, where every exchange crosses a process boundary (on the eager
    and on the kernel route); an x -> d -> x reshard round trip.

The pair is 32x48, D=8, r=2 (tests/test_distributed.py's).  Each worker
holds its ``Shard``s against the port's unsharded ``match_pair`` bit for
bit and writes them out; the test assembles each map from every process's
shards and holds it against the reference's ``match_pair`` at
``backend="jnp"`` on the same numpy inputs, at assert_agree's bars, and
the bytes each exchange sent against the layouts' arithmetic.  The
transport's order and tags, with two shards per rank, are checked in one
process with two threads as the ranks.
"""

import collections
import os
import socket
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aswstereomatch_tpu.config import StereoConfig as RefConfig
from aswstereomatch_tpu.models import pipeline as ref_pipeline
from aswstereomatch_tpu.utils import synthetic

from aswstereomatch_torch.parallel import collectives, tiling

from test_torch_sharding import J, assert_agree

H, W, D, R = 32, 48, 8, 2
REF_CFG = RefConfig(
    max_disparity=D, cost="tad_grad", aggregation="asw", window_radius=R,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True, backend="jnp",
)

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)  # several workers beside tier-1's six: keep the cores
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import (collectives, distributed, dshard, mesh,
                                               reshard, tiling)

    pid, nproc, ndev, route, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4], sys.argv[5])
    distributed.initialize("127.0.0.1:{port}", nproc, pid, backend="gloo")
    if route == "kernel":
        # K1's wrapper with its shard inputs, computing its plain version on
        # the CPU (tests/test_torch_sharding_kernel.py)
        pipeline._resolve_backend = lambda cfg, device: "cuda"
    cfg = StereoConfig(max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
                       lr_check=True, fill_holes=True, subpixel=True, median_filter=True)
    pairs = np.load(out + "/pairs.npz")
    lefts, rights = pairs["lefts"], pairs["rights"]
    l0, r0 = torch.from_numpy(lefts[0]), torch.from_numpy(rights[0])
    cpu = [torch.device("cpu")] * ndev
    unsharded = {}

    def want(c):
        if c not in unsharded:
            unsharded[c] = torch.stack([pipeline.match_pair(torch.from_numpy(a),
                                                            torch.from_numpy(b), c)
                                        for a, b in zip(lefts, rights)])
        return unsharded[c]

    saved = {}

    def keep(label, got, ref, m):
        # a mesh all of whose shards are this process's returns the whole map
        shards = [mesh.Shard(tuple(slice(0, s) for s in ref.shape), got)] if m.is_local else got
        assert (len(shards) > 0) == any(r == pid for r in m.ranks.flat), (label, len(shards))
        for s in shards:
            assert s.data.dtype == torch.float32
            assert torch.equal(s.data, ref[s.index]), label
            key = label + "@" + "_".join(f"{sl.start}-{sl.stop}" for sl in s.index)
            saved[key] = s.data.numpy()

    def sent(fn):
        before = dict(collectives.sent_bytes)
        res = fn()
        return res, {k: v - before.get(k, 0) for k, v in collectives.sent_bytes.items()}

    layouts = {"y": tiling.match_pair_tiled, "x": tiling.match_pair_tiled_x,
               "d": dshard.match_pair_dsharded}
    kcfg = cfg.replace(kernel_layout="xlanes") if route == "kernel" else cfg
    if nproc == 2:
        gm = distributed.global_mesh(tile=4, devices=cpu)  # data 2 x tile 4
        assert gm.shape == {"data": 2, "tile": 4} and gm.ranks.tolist() == [[0] * 4, [1] * 4]
        first4 = mesh.build_mesh(1, 4, distributed.global_devices(cpu))  # process 0's
        all8 = distributed.global_mesh(tile=8, devices=cpu)
        meshes = {"x": first4, "d": all8, "y": all8}
    else:
        gm = distributed.global_mesh(tile=2, devices=cpu)  # data 2 x tile 2
        assert gm.ranks.tolist() == [[0, 1], [2, 3]]
        all4 = distributed.global_mesh(tile=4, devices=cpu)
        meshes = {"x": all4, "d": all4, "y": all4}
    traffic = {}
    if route == "eager":
        shards, traffic["batch"] = sent(
            lambda: distributed.run_batch_distributed(lefts, rights, cfg, gm))
        keep("batch", shards, want(cfg), gm)
    for axis, m in meshes.items():
        c = kcfg if axis in "xd" else cfg
        got, traffic[axis] = sent(lambda: layouts[axis](l0, r0, c, m))
        keep(axis, got, want(c)[0], m)
        if not any(r == pid for r in m.ranks.flat):
            assert traffic[axis] == {} or not any(traffic[axis].values()), traffic[axis]

    if nproc == 4 and route == "eager":
        # x -> d -> x over the four processes: this process's block of one
        # (16, 32, 8) volume, the other placement's block back
        vol = torch.from_numpy(np.random.default_rng(5).random((16, 32, 8)).astype(np.float32))
        blk = torch.tensor_split(vol, 4, dim=1)[pid]
        ds, traffic["x_to_d"] = sent(lambda: reshard.x_to_d([blk], all4))
        assert len(ds) == 1 and torch.equal(ds[0], vol[:, :, 2 * pid:2 * pid + 2])
        back, traffic["d_to_x"] = sent(lambda: reshard.d_to_x(ds, all4))
        assert len(back) == 1 and torch.equal(back[0], blk)
    for name, counts in traffic.items():
        for kind, n in counts.items():
            saved[f"bytes:{name}:{kind}"] = np.array(n)
    np.savez(f"{out}/shards_{pid}.npz", **saved)
    print(f"proc {pid} OK")
    """
)


def _run_cluster(tmp_path, nproc, ndev, route, timeout=120):
    """Run the worker in ``nproc`` processes of ``ndev`` CPU devices each on
    a free port; every process must exit 0 within ``timeout`` seconds."""
    pairs = [synthetic.make_pair(height=H, width=W, max_disparity=D, seed=s) for s in range(4)]
    lefts = np.stack([p["left"] for p in pairs])
    rights = np.stack([p["right"] for p in pairs])
    np.savez(tmp_path / "pairs.npz", lefts=lefts, rights=rights)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("{port}", str(port)))
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(nproc), str(ndev),
                               route, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=repo_root)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
    saved = [dict(np.load(tmp_path / f"shards_{i}.npz")) for i in range(nproc)]
    return lefts, rights, saved


def _assemble(saved, label, shape):
    """The map of ``label`` from every process's shards; each entry must be
    covered, and shards that overlap (the d layout's replicas) agree."""
    out = np.full(shape, np.nan, np.float32)
    for per_proc in saved:
        for key, data in per_proc.items():
            name, _, index = key.partition("@")
            if name != label:
                continue
            sl = tuple(slice(*map(int, part.split("-"))) for part in index.split("_"))
            seen = out[sl]
            assert np.all(np.isnan(seen) | (seen == data)), key
            out[sl] = data
    assert not np.isnan(out).any(), f"{label}: {np.isnan(out).sum()} entries not covered"
    return out


def _bytes(saved, name, kind):
    return sum(int(p.get(f"bytes:{name}:{kind}", 0)) for p in saved)


def _check_against_reference(lefts, rights, saved):
    ref = [np.asarray(J(ref_pipeline.match_pair, cfg=REF_CFG)(jnp.asarray(a), jnp.asarray(b)))
           for a, b in zip(lefts, rights)]
    for axis in "yxd":
        assert_agree(_assemble(saved, axis, (H, W)), ref[0])
    if any(k.startswith("batch@") for p in saved for k in p):
        batch = _assemble(saved, "batch", (len(lefts), H, W))
        for i in range(len(lefts)):
            assert_agree(batch[i], ref[i])


def _halo_y_bytes(n, channels=3):
    """Both images' halo_y = r + 1 rows each way over each of n - 1 boundaries."""
    return (n - 1) * 2 * 2 * (R + 1) * W * channels * 4


def test_two_processes_of_four_devices(tmp_path):
    """The batch on data 2 x tile 4 (each tile group inside a process); x on
    process 0's four devices (process 1 owns none and sends nothing); d and
    y over all 8, across the two processes."""
    lefts, rights, saved = _run_cluster(tmp_path, 2, 4, "eager")
    _check_against_reference(lefts, rights, saved)
    assert _bytes(saved[1:], "x", "halo") == _bytes(saved[1:], "x", "gather") == 0
    assert _bytes(saved, "batch", "halo") == 0  # no tile group spans the two
    assert _bytes(saved, "y", "halo") == _halo_y_bytes(2)  # one boundary crosses
    # d: each of 8 shards' six (H, W) planes to the other process's first shard
    assert _bytes(saved, "d", "gather") == 8 * 6 * H * W * 4


@pytest.mark.parametrize("route", ["eager", "kernel"])
def test_four_processes_of_one_device(tmp_path, route):
    """Every shard in its own process: the batch on data 2 x tile 2 and x,
    d and y over all four; an x -> d -> x reshard round trip.  The bytes
    each exchange sent, summed over the processes, are the layouts'."""
    lefts, rights, saved = _run_cluster(tmp_path, 4, 1, route)
    _check_against_reference(lefts, rights, saved)
    n, ws, hl = 4, W // 4, R + D - 1
    # x: the stacks' (7, H, .) halos: (r, r + D - 1) columns forward, (r, r) back
    assert _bytes(saved, "x", "halo") == (n - 1) * 7 * H * (R + hl + 2 * R) * 4
    assert _bytes(saved, "x", "strip") == (n - 1) * H * (D - 1) * 8
    assert _bytes(saved, "x", "gather") == n * (n - 1) * 5 * H * ws * 4
    assert _bytes(saved, "d", "gather") == n * (n - 1) * 6 * H * W * 4
    assert _bytes(saved, "y", "halo") == _halo_y_bytes(n)
    if route == "eager":
        # two data rows of two pairs, one boundary each
        assert _bytes(saved, "batch", "halo") == 2 * 2 * _halo_y_bytes(2)
        # each process sends 3 of its 4 (16, 8, 2) pieces each way
        assert _bytes(saved, "x_to_d", "all_to_all") == n * 3 * 16 * 8 * 2 * 4
        assert _bytes(saved, "d_to_x", "all_to_all") == n * 3 * 16 * 8 * 2 * 4


class _Wire:
    """An in-process stand-in for ``torch.distributed``'s point-to-point
    calls between threads playing two ranks: a send is matched to the
    first receive with the same (source rank, destination rank, tag), in
    the order they were posted, as gloo matches them, and each rank's
    posted ops are recorded."""

    class Op:
        def __init__(self, op, tensor, peer, tag=0):
            self.op, self.tensor, self.peer, self.tag = op, tensor, peer, tag

    def __init__(self):
        self.box = collections.defaultdict(collections.deque)
        self.cond, self.posted = threading.Condition(), {}
        self.rank = threading.local()

    def batch_isend_irecv(self, ops):
        me = self.rank.value
        self.posted.setdefault(me, []).append([(o.op.__name__, o.peer, o.tag) for o in ops])
        works = []
        for o in ops:
            if o.op is dist.isend:
                with self.cond:
                    self.box[(me, o.peer, o.tag)].append(o.tensor.clone())
                    self.cond.notify_all()
            else:
                works.append((me, o))
        wire = self

        class Work:
            def __init__(self, me, o):
                self.me, self.o = me, o

            def wait(self):
                key = (self.o.peer, self.me, self.o.tag)
                with wire.cond:
                    assert wire.cond.wait_for(lambda: wire.box[key], timeout=30), key
                    self.o.tensor.copy_(wire.box[key].popleft())

        return [Work(me, o) for me, o in works]


def test_transport_order_and_tags_two_shards_per_rank(monkeypatch):
    """Two ranks of two shards each ([cpu] * 2 per rank), played by two
    threads over an in-process wire: the halo exchange, the gather and the
    all-to-all give each rank what the one-process group of the same four
    shards gives, each rank posts its ops in (source, destination, part)
    order with the tags that triple makes, and the gather of shard 0's
    parts reaches rank 1's first shard only."""
    wire = _Wire()
    monkeypatch.setattr(dist, "P2POp", _Wire.Op)
    monkeypatch.setattr(dist, "batch_isend_irecv", wire.batch_isend_irecv)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    cpu = torch.device("cpu")
    owners = [(0, cpu), (0, cpu), (1, cpu), (1, cpu)]
    rng = np.random.default_rng(3)
    blocks = {k: [torch.from_numpy(rng.random((5, 6)).astype(np.float32)),
                  torch.from_numpy(rng.integers(0, 9, (5, 6)).astype(np.int32))]
              for k in range(4)}
    halos = [(2, 1), (3, 2)]

    def run(group):
        halo = tiling._exchange(group, {k: blocks[k] for k in group.local}, halos, 1)
        gathered = collectives.all_gather(group, {k: blocks[k] for k in group.local})
        pieces = {k: torch.tensor_split(blocks[k][0], 4, dim=0) for k in group.local}
        a2a = collectives.all_to_all(group, pieces,
                                     lambda i, j: (pieces[j][j].shape, pieces[j][j].dtype))
        return halo, gathered, a2a

    want = run(collectives.Group([(0, cpu)] * 4, 0))
    got, errors = {}, []

    def rank(r):
        wire.rank.value = r
        try:
            got[r] = run(collectives.Group(owners, r))
        except BaseException as e:  # noqa: BLE001  (re-raised in the test's thread)
            errors.append(e)
            raise

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert not any(wire.box.values()), f"unreceived messages {sorted(wire.box)}"
    for r, local in ((0, [0, 1]), (1, [2, 3])):
        halo, gathered, a2a = got[r]
        for k in local:
            assert all(torch.equal(a, b) for a, b in zip(halo[k], want[0][k]))
            assert all(torch.equal(a, b) for a, b in zip(a2a[k], want[2][k]))
        rep = local[0]
        assert list(gathered) == [rep]
        for parts, ref in zip(gathered[rep], want[1][0]):
            assert all(torch.equal(a, b) for a, b in zip(parts, ref))
    for r, posted in wire.posted.items():
        for ops in posted:
            tags = [tag for _, _, tag in ops]
            assert tags == sorted(tags), (r, ops)
    # rank 0's halo exchange: shard 1 -> 2 (two parts, forward) and the
    # receive of shard 2 -> 1; tags (src * 4 + dst) * MAX_PARTS + part
    mp = collectives.MAX_PARTS
    assert wire.posted[0][0] == [("isend", 1, 6 * mp), ("isend", 1, 6 * mp + 1),
                                 ("irecv", 1, 9 * mp), ("irecv", 1, 9 * mp + 1)]
    assert wire.posted[1][0] == [("irecv", 0, 6 * mp), ("irecv", 0, 6 * mp + 1),
                                 ("isend", 0, 9 * mp), ("isend", 0, 9 * mp + 1)]
