"""Two processes over a gloo loopback group: the port's multi-process batch
runner (``parallel.distributed``), as tests/test_distributed.py runs the
reference's.

Each process brings up the group with ``initialize(host:port, 2, rank,
backend="gloo")``, builds the global mesh over 4 CPU devices of its own
(data 2 across the processes, tile 4 within each), matches its half of a
batch of 16 pairs (32x48, D=8) and checks every local result shard against
the port's unsharded ``match_pair`` bit for bit.  A tile axis of 8 spans
the processes: each owns its 4 entries (the layouts over it are
tests/test_torch_distributed_tile.py's).  Runs as subprocesses on a free
port, so the test process keeps no process group.
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)  # two workers beside tier-1's six: keep the cores
    import torch.distributed as dist
    from aswstereomatch_torch.config import StereoConfig
    from aswstereomatch_torch.models import pipeline
    from aswstereomatch_torch.parallel import distributed
    from aswstereomatch_torch.utils import synthetic

    pid = int(sys.argv[1])
    distributed.initialize("127.0.0.1:{port}", num_processes=2, process_id=pid, backend="gloo")
    distributed.initialize("127.0.0.1:{port}", num_processes=2, process_id=pid)  # no-op
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"

    cfg = StereoConfig(
        max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
        lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
    )
    pairs = [synthetic.make_pair(height=32, width=48, max_disparity=8, seed=s)
             for s in range(16)]
    lefts = np.stack([p["left"] for p in pairs])
    rights = np.stack([p["right"] for p in pairs])

    cpu = [torch.device("cpu")] * 4
    m = distributed.global_mesh(tile=4, devices=cpu)  # data=2 across processes
    assert m.shape == {"data": 2, "tile": 4}, m.shape
    assert m.ranks.tolist() == [[0] * 4, [1] * 4] and m.rank == pid
    assert m.local_shards() == [(pid, k) for k in range(4)]
    shards = distributed.run_batch_distributed(lefts, rights, cfg, m)
    assert len(shards) == 4
    covered = set()
    for s in shards:
        bs, rows = s.index
        assert (bs.start, bs.stop) == (8 * pid, 8 * pid + 8), s.index
        for bi in range(bs.start, bs.stop):
            ref = pipeline.match_pair(torch.from_numpy(lefts[bi]),
                                      torch.from_numpy(rights[bi]), cfg)
            got = s.data[bi - bs.start]
            assert torch.equal(got, ref[rows]), (bi, rows)
            covered.update((bi, y) for y in range(rows.start, rows.stop))
    assert covered == {(b, y) for b in range(8 * pid, 8 * pid + 8) for y in range(32)}

    # one pair's tile axis over both processes' devices
    span = distributed.global_mesh(tile=8, devices=cpu)
    assert span.shape == {"data": 1, "tile": 8}, span.shape
    assert span.owners(0) == [(0, cpu[0])] * 4 + [(1, cpu[0])] * 4
    assert span.local_shards() == [(0, 4 * pid + k) for k in range(4)] and not span.is_local

    # the group works: the processes agree on the pairs matched
    n = torch.tensor([sum(s.data.shape[0] for s in shards if s.index[1].start == 0)])
    dist.all_reduce(n)
    assert int(n) == 16, int(n)
    dist.destroy_process_group()
    print(f"proc {pid} OK")
    """
)


def test_two_process_loopback(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("{port}", str(port)))
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=repo_root)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
