"""The multi-device layer of siriltpu_torch against siriltpu:
``parallel/mesh.py``, ``parallel/sharded.py`` and the ``mesh=`` of the
star finder, the warp and global star registration.

The JAX package runs on its 8 virtual CPU devices (tests/conftest.py);
the port on meshes of 8 CPU entries (one device repeated), its analog.
Every sharded result is held to the port's unsharded one bit for bit
(the partition changes nothing). Against the JAX package: the sum stack,
the register + stack and the row-slab stack at tolerance 0; the star
finder, the warp and global alignment at the tolerances of
test_torch_starfind.py and test_torch_global.py, whose docstrings give
the reasons (the f32 LM fit's sums, XLA's fused multiply-adds): star
positions within 2e-3 px, warped words within 1 LSB on at most 0.1%,
homographies within 1e-3 and aligned words within 3 LSB on at most 5%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu.parallel import mesh as jmesh  # noqa: E402
from siriltpu.parallel import sharded as jsharded  # noqa: E402
from siriltpu.testing.synth import make_sequence_frames, starfield  # noqa: E402
from siriltpu.verify import oracle as joracle  # noqa: E402

from siriltpu_torch.ops import starfind as tsf  # noqa: E402
from siriltpu_torch.ops import warp as tw  # noqa: E402
from siriltpu_torch.parallel import mesh as tmesh  # noqa: E402
from siriltpu_torch.parallel import multihost as tmh  # noqa: E402
from siriltpu_torch.parallel import sharded as tsharded  # noqa: E402
from siriltpu_torch.registration import global_star as tg  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402
from siriltpu_torch.verify import oracle as toracle  # noqa: E402

from test_torch_full import build_ser, jx  # noqa: E402,F401
from test_torch_global import (H_CONFIG4, INTERPS, jax_bounds,  # noqa: E402
                               make_affine, scene, warp_image)


def cpu_mesh(n: int = 8, axes=("frames",), shape=None):
    return tmesh.make_mesh(axes, shape, devices=["cpu"] * n)


def words_close(got, want, lsb: int, frac: float, ctx=""):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= lsb, (ctx, d.max())
    assert (d != 0).mean() <= frac, (ctx, (d != 0).mean())


# ------------------------------------------------------------------- mesh

def test_mesh_has_8_entries_and_no_fallback():
    mesh = cpu_mesh()
    assert mesh.shape == {"frames": 8} == dict(jmesh.make_mesh().shape)
    assert mesh.size == 8 and mesh.is_local() and set(mesh.ranks.flat) == {0}
    two = cpu_mesh(8, ("frames", "rows"), (2, 4))
    assert two.shape == {"frames": 2, "rows": 4}
    assert [d for d, _ in two.axis_entries("rows")] == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="mesh shape"):
        cpu_mesh(8, ("frames", "rows"), (3, 3))
    if not torch.cuda.is_available():
        # the default devices are the cards: none, and nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmh.init_distributed("localhost:1", 1, 0)


@pytest.mark.parametrize("nframes", [1, 8, 11, 16, 17])
def test_pad_frames(nframes):
    assert tmesh.pad_frames_to_mesh(nframes, cpu_mesh()) \
        == jmesh.pad_frames_to_mesh(nframes, jmesh.make_mesh())
    assert tmesh.pad_frames_to_mesh(nframes, cpu_mesh(3)) == -(-nframes // 3) * 3


def frame_local(frames, scale):
    """A frame-local function of a tensor pytree: each frame's sum, a
    scaled copy, a list entry and a dict, per frame."""
    wide = frames.to(torch.int64)
    sums = wide.sum(dim=(1, 2))
    return (sums, {"scaled": wide * scale[:, None, None]},
            [int(s) for s in sums])


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_run_frames_sharded_equals_unsharded(shards):
    rng = np.random.default_rng(shards)
    frames = rng.integers(0, 65536, (11, 5, 7)).astype(np.uint16)
    scale = rng.integers(1, 9, 11).astype(np.int64)
    got = tmesh.run_frames_sharded(frame_local, cpu_mesh(shards), frames, scale)
    want = frame_local(interop.frames_from_numpy(frames, "cpu"),
                       torch.from_numpy(scale))
    assert torch.equal(got[0], want[0]) and got[2] == want[2]
    assert torch.equal(got[1]["scaled"], want[1]["scaled"])
    # a uint16 tensor in, a uint16 tensor out, trimmed to the frames
    u16 = tmesh.run_frames_sharded(lambda x: x, cpu_mesh(shards),
                                   interop.frames_from_numpy(frames, "cpu"))
    np.testing.assert_array_equal(interop.u16_to_numpy(u16), frames)


# ------------------------------------------------------------ sum stacking

@pytest.mark.parametrize("case", ["rescaled", "in_range"])
def test_sharded_sum_stack_matches_oracles_and_jax(case):
    if case == "rescaled":
        frames, _, shifts = make_sequence_frames(11, 32, 40, seed=90)
    else:   # a sum below 65535: no rescale
        frames, _, shifts = make_sequence_frames(3, 24, 20, seed=92)
        frames = (frames // 8).astype(np.uint16)
    got, hi = tsharded.make_sharded_sum_stack(cpu_mesh())(frames[:, 0], shifts)
    want, hi_w = toracle.stack_sum(frames, shifts)
    jwant, jhi = joracle.stack_sum(frames, shifts)
    jrun, jrun_hi = jsharded.make_sharded_sum_stack(jmesh.make_mesh())(
        frames[:, 0], shifts)
    assert got.dtype == np.uint16
    for w in (want[0], jwant[0], jrun):
        np.testing.assert_array_equal(got, w)
    assert hi == hi_w == jhi == jrun_hi
    assert (hi == 65535) == (case == "rescaled")
    # unsharded, and without shifts
    one, _ = tsharded.make_sharded_sum_stack(cpu_mesh(1))(frames[:, 0], shifts)
    np.testing.assert_array_equal(one, got)
    np.testing.assert_array_equal(
        tsharded.make_sharded_sum_stack(cpu_mesh(3))(frames[:, 0])[0],
        toracle.stack_sum(frames, np.zeros((len(frames), 2), np.int32))[0][0])


# ------------------------------------------------- register + reject stack

@pytest.fixture(scope="module")
def registered():
    n = 8
    gen = np.zeros((n, 2), dtype=np.int64)
    gen[1:] = np.random.default_rng(91).integers(-4, 5, (n - 1, 2))
    frames, _, _ = make_sequence_frames(n, 64, 64, seed=91, shifts=gen,
                                        noise_sigma=4.0)
    out, shifts = jsharded.make_sharded_register_stack(
        jmesh.make_mesh(), sel=(8, 8, 48))(frames[:, 0])
    return frames, gen, out, shifts


@pytest.mark.parametrize("entries", [8, 2, 1])
def test_sharded_register_stack_matches_jax(registered, entries):
    frames, gen, jout, jshifts = registered
    out, shifts = tsharded.make_sharded_register_stack(
        cpu_mesh(entries), sel=(8, 8, 48))(frames[:, 0])
    np.testing.assert_array_equal(shifts[:, 0], -gen[:, 0])
    np.testing.assert_array_equal(shifts[:, 1], -gen[:, 1])
    np.testing.assert_array_equal(shifts, jshifts)
    np.testing.assert_array_equal(out, jout)
    # equals the single-device pipeline result
    want = tapi.stack_frames(frames, device="cpu", method="mean", shifts=shifts,
                             rejection="sigma", sig=(3.0, 3.0))
    np.testing.assert_array_equal(out, want.data[0])


def test_register_stack_step_and_refusals(registered):
    frames, _, jout, jshifts = registered
    out, sx, sy = tsharded.register_stack_step((8, 8, 48))(
        interop.frames_from_numpy(frames[:, 0], "cpu"))
    np.testing.assert_array_equal(interop.u16_to_numpy(out), jout)
    np.testing.assert_array_equal(interop.shifts_to_numpy(sx, sy), jshifts)
    with pytest.raises(ValueError, match="not divisible"):
        tsharded.make_sharded_register_stack(cpu_mesh(3), (8, 8, 48))(frames[:, 0])
    with pytest.raises(ValueError, match="does not fit"):
        tsharded.make_sharded_register_stack(cpu_mesh(2), (30, 8, 48))(frames[:, 0])


@pytest.mark.parametrize("rejection,sig", [
    ("sigma", (2.0, 2.0)), ("winsorized", (2.0, 2.0)),
    ("percentile", (0.2, 0.1)), ("none", (3.0, 3.0))])
def test_sharded_register_stack_rejections(registered, rejection, sig):
    """Other rejections: their kernels' plain versions, or reject_and_mean
    where there is no kernel (none), as JAX's. (linearfit's plain f32 fit
    differs from JAX's on knife-edge pixels, test_torch_linearfit.py.)"""
    frames = registered[0]
    out, shifts = tsharded.make_sharded_register_stack(
        cpu_mesh(4), (8, 8, 48), rejection, sig)(frames[:, 0])
    jout, jshifts = jsharded.make_sharded_register_stack(
        jmesh.make_mesh(), (8, 8, 48), rejection, sig)(frames[:, 0])
    np.testing.assert_array_equal(shifts, jshifts)
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_rows_slab_stack_2d_mesh(shape, monkeypatch):
    """P3 row-slab rejection stacking on a 2-D (frames, rows) mesh equals
    JAX's and the single-device stack; h = 21 leaves a short last slab
    (JAX pads it). The kernel takes contiguous (F, P) values, so every
    slab handed to the rejection must be contiguous, also when the frames
    are a slice of taller ones."""
    import jax.numpy as jnp
    from siriltpu.ops.rejection import reject_and_mean

    from siriltpu_torch.ops.cuda.reject_stack import reject_plain

    stacked = []

    def contiguous_only(flat, rejection, sig):
        assert flat.is_contiguous()
        stacked.append(flat.shape)
        return stack_rejected(flat, rejection, sig)

    stack_rejected = tsharded.stack_rejected
    monkeypatch.setattr(tsharded, "stack_rejected", contiguous_only)
    rng = np.random.default_rng(77)
    f, h, w = 12, 21, 16
    frames = np.clip(rng.normal(2000, 150, (f, h, w)), 0, 65535).astype(np.uint16)
    frames[4, 10, 3] = 64000
    run = tsharded.make_rows_sigma_stack(cpu_mesh(8, ("frames", "rows"), shape))
    got = run(frames)
    # the slabs cover the rows once, each over every frame
    assert sum(p for _, p in stacked) == h * w and {n for n, _ in stacked} == {f}
    taller = interop.frames_from_numpy(
        np.concatenate([frames, frames[:, :3]], axis=1), "cpu")
    np.testing.assert_array_equal(run(taller[:, :h]), got)
    jgot = jsharded.make_rows_sigma_stack(
        jmesh.make_mesh(("frames", "rows"), shape=shape))(frames)
    want, _, _ = reject_and_mean(
        jnp.asarray(frames.reshape(f, h * w), jnp.float32), "sigma", (3.0, 3.0))
    plain = reject_plain(interop.frames_from_numpy(frames.reshape(f, h * w), "cpu"),
                         "sigma", 3.0, 3.0)[0]
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, np.asarray(want).reshape(h, w))
    np.testing.assert_array_equal(got, interop.u16_to_numpy(plain).reshape(h, w))
    assert got[10, 3] < 3000      # the outlier is rejected


# ------------------------------------------------------------ multi-process

def test_local_frame_indices_world_1():
    sharding = tmesh.frames_sharding(cpu_mesh())
    assert tmh.local_frame_indices(sharding, (32, 8, 8)) == list(range(32))


@pytest.mark.parametrize("rank", [0, 1])
def test_local_frame_indices_two_ranks(rank):
    """A mesh of 2 processes x 4 entries: each process owns its half."""
    mesh = tmesh.Mesh(np.array([torch.device("cpu")] * 8, dtype=object),
                      ("frames",), ranks=np.repeat([0, 1], 4))
    assert not mesh.is_local()
    sharding = tmesh.frames_sharding(mesh)
    got = tmh.local_frame_indices(sharding, (16, 8, 8), rank=rank)
    assert got == list(range(8 * rank, 8 * rank + 8))
    rows = tmesh.rows_sharding(mesh).indices_map((16, 24, 8), rank)
    assert sorted(r[1].start for r in rows.values()) == \
        list(range(12 * rank, 12 * rank + 12, 3))


# ----------------------------------------------------- the stubs, closed

def star_layers(n: int = 8, h: int = 128, w: int = 128):
    return np.stack([starfield(h, w, 8, seed=300 + i, background=900,
                               noise_sigma=4.0)[0][0] for i in range(n)])


def test_peaker_batch_sharded_over_frames_mesh():
    """As tests/test_star_pipeline.py:285: sharded == unsharded (bit for
    bit in the port), and within the star finders' tolerance of JAX's."""
    from siriltpu.ops.starfind import peaker_batch

    layers = star_layers()
    plain = tsf.peaker_batch(layers, device="cpu", nmax=128)
    for n in (8, 3):
        assert tsf.peaker_batch(layers, device="cpu", nmax=128,
                                mesh=cpu_mesh(n)) == plain
    jax_sharded = peaker_batch(layers, nmax=128, mesh=jmesh.make_mesh())
    assert [len(s) for s in plain] == [len(s) for s in jax_sharded]
    for ps, js in zip(plain, jax_sharded):
        g, w = interop.stars_to_fields(ps), interop.stars_to_fields(js)
        for k in ("xpos", "ypos"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=2e-3)
        np.testing.assert_allclose(g["mag"], w["mag"], rtol=0, atol=1e-3)


def test_global_align_batch_sharded():
    """As tests/test_global_alignment.py:269, on test_torch_global.py's
    scene (4 frames over 8 entries: the pad path), whose tolerances
    against JAX were measured there."""
    from siriltpu.registration.global_star import global_align_batch

    layers = scene()[:, 0]
    a1, r1 = tg.global_align_batch(layers, 0, device="cpu", nmax=2048)
    a2, r2 = tg.global_align_batch(layers, 0, device="cpu", nmax=2048,
                                   mesh=cpu_mesh())
    j2, jr2 = global_align_batch(layers, 0, nmax=2048, mesh=jmesh.make_mesh())
    assert r1.registered == r2.registered == jr2.registered == 4
    for h1, h2, hj in zip(r1.homographies, r2.homographies, jr2.homographies):
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_allclose(h2, hj, atol=1e-3)
    np.testing.assert_array_equal(a1, a2)
    words_close(a2, j2, 3, 0.05)


@pytest.mark.parametrize("interp", INTERPS)
def test_warp_batch_dev_sharded(interp):
    """Three layers over 8 entries (test_torch_global.py's warp case): the
    port's unsharded words bit for bit, JAX's sharded words within that
    file's bounds."""
    from siriltpu.ops.warp import warp_batch_dev

    layers = np.stack([warp_image(s, 96, 160) for s in range(3)])
    Hs = np.stack([np.eye(3), make_affine(angle_deg=-0.4, tx=-3.3, ty=1.7),
                   H_CONFIG4])
    plain = interop.u16_to_numpy(tw.warp_batch_dev(layers, Hs, (96, 160), interp,
                                                   device="cpu"))
    got = interop.u16_to_numpy(tw.warp_batch_dev(layers, Hs, (96, 160), interp,
                                                 device="cpu", mesh=cpu_mesh()))
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(warp_batch_dev(layers, Hs, (96, 160), interp,
                                     mesh=jmesh.make_mesh()))
    words_close(got, want, *jax_bounds(interp), interp)


def test_register_global_star_sharded(tmp_path):
    """register_global_star over a 4-entry frames mesh in chunks of 3 (each
    chunk takes the pad path): the port's frames and homographies
    equal its unsharded run; JAX's sharded run agrees within the
    end-to-end tolerance of test_torch_global.py."""
    from siriltpu.core.frame import Frame as JFrame
    from siriltpu.io.sequence import internal_sequence as jinternal
    from siriltpu.registration.global_star import register_global_star

    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.sequence import internal_sequence

    layers = scene()[:, 0]
    runs = {}
    for name, mesh in (("plain", None), ("sharded", cpu_mesh(4))):
        seq = internal_sequence([Frame(l[None]) for l in layers])
        out = []
        rep = tg.register_global_star(seq, 0, device="cpu", write_output=False,
                                      output_frames=out, mesh=mesh, chunk_frames=3)
        runs[name] = rep, np.stack([f.data[0] for f in out])
    jseq = jinternal([JFrame(l[None]) for l in layers])
    jout = []
    jrep = register_global_star(jseq, 0, write_output=False, output_frames=jout,
                                mesh=jmesh.make_mesh(), chunk_frames=8)
    (rp, ap), (rs, as_) = runs["plain"], runs["sharded"]
    assert rp.registered == rs.registered == jrep.registered == 4
    np.testing.assert_array_equal(as_, ap)
    for hp, hs, hj in zip(rp.homographies, rs.homographies, jrep.homographies):
        np.testing.assert_array_equal(hs, hp)
        np.testing.assert_allclose(hs, hj, atol=1e-3)
    words_close(as_, np.stack([f.data[0] for f in jout]), 3, 0.05)


def test_config5_pipeline_sharded(jx, tmp_path):
    """config5_pipeline(mesh=) on test_torch_full.py's RGB SER (4 frames,
    global registration over 3 entries): the r_ frames and the output
    equal the unsharded run's; JAX's chain with its mesh registers the
    same frames."""
    from siriltpu_torch.io import fits as tfits
    from siriltpu_torch.pipelines import full as tfull

    runs = {}
    for name, mesh in (("plain", None), ("sharded", cpu_mesh(3)), ("jax", None)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "lights.ser")
        build_ser(jx, path, False)
        kw = dict(layer=1, rejection="winsorized", bg_order=2)
        rep = (jx.full.config5_pipeline(path, mesh=jmesh.make_mesh(), **kw)
               if name == "jax" else
               tfull.config5_pipeline(path, device="cpu", mesh=mesh, **kw))
        runs[name] = (d, rep, tfits.read_fits(rep.output_path).data)
    (dp, rp, op), (ds, rs, os_), (_, rj, _) = (runs["plain"], runs["sharded"],
                                               runs["jax"])
    assert (rs.registered, rs.failed) == (rp.registered, rp.failed) \
        == (rj.registered, rj.failed) == (4, 0)
    assert (ds / "r_bkg_lights.ser").read_bytes() == (dp / "r_bkg_lights.ser").read_bytes()
    np.testing.assert_array_equal(os_, op)
