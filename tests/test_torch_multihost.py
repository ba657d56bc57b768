"""Multi-process scale-out of siriltpu_torch: a REAL 2-process gloo
cluster, against siriltpu's single-process result (tests/test_multihost.py).

Two fresh processes (``python -m siriltpu_torch.parallel._mh_worker``)
each own 4 CPU mesh entries, join one process group through a file under
the test's directory (no port to pick, so parallel test workers cannot
collide), build the 8-entry global mesh, feed ONLY their own frame shard
(from a shared SER file, or from memory), and run the register + stack.
Every process must produce exactly the JAX package's single-process
result, tolerance 0. Every process group lives in a subprocess: the test
process keeps none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "siril-0.9_tpu")
#: seconds a worker may take before both are killed
TIMEOUT = 120


def _run_all(commands, what):
    """Start every command at once (PYTHONPATH with the port) and wait
    for all of them, killing each that outlives TIMEOUT; returns their
    (return code, output) pairs."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = _PKG + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd in commands]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what} hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("feed", ["disk", "memory"])
def test_two_process_cluster_matches_single_process(tmp_path, feed):
    from siriltpu.parallel._mh_worker import singlehost_expected as jax_expected

    from siriltpu_torch.parallel import _mh_worker

    if feed == "disk":
        # the workers find mh_input.ser in the outdir and read only their
        # own frames of it
        _mh_worker.write_test_ser(str(tmp_path / "mh_input.ser"))
    address = f"file://{tmp_path / 'rendezvous'}"
    results = _run_all(
        [[sys.executable, "-m", "siriltpu_torch.parallel._mh_worker",
          address, str(pid), "2", "4", str(tmp_path)] for pid in range(2)],
        "multi-process worker")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"mh_worker {pid}/2: OK entries=8 local=4 backend=gloo" in out
        assert f"fed frames [{8 * pid},{8 * pid + 8})" in out

    want = jax_expected()
    got0 = np.load(tmp_path / "out_0.npy")
    got1 = np.load(tmp_path / "out_1.npy")
    assert got0.dtype == np.uint16 and got0.shape == (_mh_worker.H, _mh_worker.W)
    np.testing.assert_array_equal(got0, got1)
    np.testing.assert_array_equal(got0, want)
    np.testing.assert_array_equal(_mh_worker.singlehost_expected(), want)


_MESH_DEFAULT = """
import sys
import torch
import torch.distributed as dist
from siriltpu_torch.parallel.mesh import make_mesh

address, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
# four cards, as a CPU build cannot show them; this process's is pid + 1
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
torch.cuda.current_device = lambda: pid + 1
alone = make_mesh()
assert [str(d) for d in alone.devices.flat] == [f"cuda:{i}" for i in range(4)], alone
dist.init_process_group("gloo", init_method=address, world_size=nprocs, rank=pid)
try:
    mesh = make_mesh()
    assert mesh.shape == {"frames": nprocs}, mesh
    assert mesh.ranks.tolist() == list(range(nprocs)), mesh
    assert str(mesh.devices[pid]) == f"cuda:{pid + 1}", mesh
    print(f"rank {pid}: OK {mesh}", flush=True)
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("nprocs", [1, 2])
def test_make_mesh_default_is_own_card_in_a_group(tmp_path, nprocs):
    """With no process group, make_mesh() takes every visible card; inside
    one, each process's own card alone (the one init_distributed pinned),
    so the mesh has one entry per process."""
    address = f"file://{tmp_path / 'rendezvous'}"
    results = _run_all([[sys.executable, "-c", _MESH_DEFAULT, address, str(pid),
                         str(nprocs)] for pid in range(nprocs)], "process")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"process {pid} failed:\n{out}"
        assert f"rank {pid}: OK" in out


def test_worker_sequence_matches_jax(tmp_path):
    """The worker's own copies: the same frames, SER file and selection."""
    from siriltpu.parallel import _mh_worker as jw

    from siriltpu_torch.parallel import _mh_worker as tw

    np.testing.assert_array_equal(tw.synth_frames(), jw.synth_frames())
    assert (tw.F, tw.H, tw.W, tw.SEL) == (jw.F, jw.H, jw.W, jw.SEL)
    tw.write_test_ser(str(tmp_path / "t.ser"))
    jw.write_test_ser(str(tmp_path / "j.ser"))
    assert (tmp_path / "t.ser").read_bytes() == (tmp_path / "j.ser").read_bytes()


def test_dryrun_multichip_on_cpu_entries(capsys):
    """The port's dryrun_multichip over 8 CPU entries: the fused step, the
    (2, 4) row-slab stack and the star alignment, each sharded ==
    unsharded."""
    from siriltpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, "cpu")
    assert "dryrun_multichip OK on 8 entries (cpu): (64, 64)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
