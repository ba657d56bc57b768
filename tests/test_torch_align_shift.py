"""siriltpu_torch.ops.cuda.align_shift: the wrapper's checks on the CPU,
and on the card the align kernel against a plain NumPy shift, word for
word, and the register + stack pipeline through it against its CPU route.
On the CPU the NumPy shift, and the CPU route of ``align_frames_auto``, are
held to the JAX package's ``_align_frames_impl`` on the card cases' shifts.

The CUDA cases carry the ``cuda`` marker and skip without a card. Only the
JAX case imports JAX or siriltpu, inside its body; on a machine with a card
the file runs with:

    PYTHONPATH=siril-0.9_tpu python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_align_shift.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.ops.cuda.align_shift import align_shift  # noqa: E402
from siriltpu_torch.pipelines import register_stack as trs  # noqa: E402
from siriltpu_torch.utils import timing  # noqa: E402
from siriltpu_torch.utils.interop import (frames_from_numpy,  # noqa: E402
                                          u16_to_numpy)


def np_align(frames: np.ndarray, sx, sy) -> np.ndarray:
    """out[f, y, x] = frames[f, y - sy[f], x - sx[f]] inside the frame,
    else 0: one rectangle a frame, in NumPy."""
    f, h, w = frames.shape
    out = np.zeros_like(frames)
    for i in range(f):
        dx, dy = int(sx[i]), int(sy[i])
        y0, y1 = max(0, dy), min(h, h + dy)
        x0, x1 = max(0, dx), min(w, w + dx)
        if y0 < y1 and x0 < x1:
            out[i, y0:y1, x0:x1] = frames[i, y0 - dy:y1 - dy, x0 - dx:x1 - dx]
    return out


def launches() -> int:
    return timing.counters().get("align.launches", 0)


def _i32(*v):
    return torch.tensor(v, dtype=torch.int32)


_U16 = torch.zeros((2, 4, 6), dtype=torch.uint16)

#: (frames, sx, sy, error, message) the wrapper refuses
BAD = {
    "frames int16": (_U16.view(torch.int16), _i32(0, 1), _i32(0, 1), TypeError,
                     "uint16 frames"),
    "shifts int64": (_U16, _i32(0, 1).long(), _i32(0, 1), TypeError,
                     "int32 shifts"),
    "frames 2-D": (_U16[0], _i32(0, 1), _i32(0, 1), ValueError, "F, H, W"),
    "frames empty": (_U16[:0], _i32(), _i32(), ValueError, "F, H, W"),
    "shifts of 3 frames": (_U16, _i32(0, 1, 2), _i32(0, 1, 2), ValueError,
                           "shifts for 2 frames"),
    "sy of 1 frame": (_U16, _i32(0, 1), _i32(0), ValueError,
                      "shifts for 2 frames"),
    "frames not contiguous": (_U16.transpose(1, 2), _i32(0, 1), _i32(0, 1),
                              ValueError, "contiguous"),
    "on the CPU": (_U16, _i32(0, 1), _i32(0, 1), ValueError, "CUDA device"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_bad_input(case):
    frames, sx, sy, error, message = BAD[case]
    before = launches()
    with pytest.raises(error, match=message):
        align_shift(frames, sx, sy)
    assert launches() == before


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the align kernel runs only on the card")
    return torch.device("cuda")


def shift_cases(f: int, h: int, w: int, seed: int):
    """(sx, sy) lists that give each shift of the kernel's borders to each
    axis at least once, split into calls of ``f`` frames; the frames of a
    call that the list leaves over drift in [-20, 20]. The borders: 0,
    +-1, +-7, +-8, +-9 (a 16-byte block of words and its neighbours), the
    frame's side less one, the side, the side plus 5, and a shift past the
    other side."""
    rng = np.random.default_rng(seed)
    xs = [0, 1, 7, 8, 9, w - 1, w, w + 5, h + 3]
    ys = [0, 1, 7, 8, 9, h - 1, h, h + 5, w + 3]
    xs += [-v for v in xs]
    ys += [-v for v in ys]
    pairs = ([(v, int(rng.choice(ys))) for v in xs]
             + [(int(rng.choice(xs)), v) for v in ys])
    calls = []
    for a in range(0, len(pairs), f):
        part = pairs[a:a + f]
        fill = rng.integers(-20, 21, (f - len(part), 2))
        both = np.concatenate([np.array(part, np.int32).reshape(-1, 2),
                               fill.astype(np.int32)])
        calls.append((both[:, 0].copy(), both[:, 1].copy()))
    return calls


#: (F, H, W, source offset in frames): W at 1, 7, 8, 640, 641; F at 1 and
#: 1000; the north star's 4096 x 4096 at F = 2; an offset of one frame of
#: odd H * W starts the source off a 16-byte boundary
SHAPES = [(1, 3, 1, 0), (1000, 5, 1, 0), (1, 5, 7, 0), (1000, 6, 7, 1),
          (1, 4, 8, 0), (1000, 9, 8, 0), (1, 480, 640, 0), (1000, 480, 640, 0),
          (1, 11, 641, 1), (1000, 13, 641, 1), (2, 4096, 4096, 0)]


#: frames of a call of the card cases held to JAX on the CPU: the first
#: ones, which hold every border shift of the call; the rest drift in
#: [-20, 20], as in test_torch_register_stack.py::test_align_matches_jax
JAX_FRAMES = 64


@pytest.mark.parametrize("f,h,w", [s[:3] for s in SHAPES if s[1] < 4096])
def test_np_align_matches_jax(f, h, w):
    """The card cases' oracle is the JAX package's align: ``np_align``
    equals ``_align_frames_impl`` word for word on every shift list of
    ``test_cuda_kernel_matches_plain_shift`` at its shapes (4096 x 4096
    aside), and so does ``align_frames_auto`` on the CPU, which launches
    nothing."""
    import jax.numpy as jnp
    from siriltpu.pipelines.register_stack import _align_frames_impl

    n = min(f, JAX_FRAMES)
    rng = np.random.default_rng(f * 7 + h * 3 + w)
    host = rng.integers(0, 65536, (n, h, w), dtype=np.uint16)
    for sx, sy in shift_cases(f, h, w, seed=w):
        sx, sy = sx[:n], sy[:n]
        want = np.asarray(_align_frames_impl(
            jnp.asarray(host), jnp.asarray(sx), jnp.asarray(sy)))
        np.testing.assert_array_equal(np_align(host, sx, sy), want)
        before = launches()
        got = trs.align_frames_auto(frames_from_numpy(host, "cpu"),
                                    torch.from_numpy(sx), torch.from_numpy(sy))
        assert launches() == before
        np.testing.assert_array_equal(u16_to_numpy(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,w,offset", SHAPES)
def test_cuda_kernel_matches_plain_shift(cuda_device, f, h, w, offset):
    rng = np.random.default_rng(f * 7 + h * 3 + w)
    host = rng.integers(0, 65536, (f + offset, h, w), dtype=np.uint16)
    frames = frames_from_numpy(host, cuda_device)[offset:]
    for sx, sy in shift_cases(f, h, w, seed=w):
        before = launches()
        got = align_shift(frames, torch.from_numpy(sx).to(cuda_device),
                          torch.from_numpy(sy).to(cuda_device))
        torch.cuda.synchronize()
        assert launches() == before + 1
        assert got.dtype == torch.uint16 and tuple(got.shape) == (f, h, w)
        np.testing.assert_array_equal(u16_to_numpy(got),
                                      np_align(host[offset:], sx, sy))


@pytest.mark.cuda
def test_cuda_align_auto_one_launch_no_sync(cuda_device):
    """On the card ``align_frames_auto`` is one launch, its one span is
    ``align.copy`` of the kernel form (no host read of the shifts), and it
    and the stack after it wait for nothing: a host sync raises here."""
    f, h, w = 1000, 48, 64
    rng = np.random.default_rng(17)
    host = rng.integers(0, 65536, (f, h, w), dtype=np.uint16)
    sx = rng.integers(-90, 91, f).astype(np.int32)
    sy = rng.integers(-60, 61, f).astype(np.int32)
    frames = frames_from_numpy(host, cuda_device)
    dsx, dsy = (torch.from_numpy(v).to(cuda_device) for v in (sx, sy))
    torch.cuda.synchronize()
    before = launches()
    timing.collect()
    timing.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aligned = trs.align_frames_auto(frames, dsx, dsy)
        trs.stack_rejected(aligned.reshape(f, h * w), "winsorized", (3.0, 3.0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timing.disable()
    torch.cuda.synchronize()
    assert launches() == before + 1
    assert [(s.name, s.attrs) for s in timing.collect()] == [
        ("align.copy", {"form": "kernel"}),
        ("stack.reject", {"shape": (f, h * w), "rejection": "winsorized"})]
    np.testing.assert_array_equal(u16_to_numpy(aligned), np_align(host, sx, sy))


def drifting_sky(f: int, h: int, w: int, seed: int):
    """(F, H, W) uint16 frames of one sky of 300 bright points drifting by
    (sx, sy) in [-20, 20] (frame 0 fixed) with zero fill, plus fresh noise,
    and the drifts."""
    rng = np.random.default_rng(seed)
    sky = np.full((h, w), 1000, np.uint16)
    sky[rng.integers(4, h - 4, 300), rng.integers(4, w - 4, 300)] = \
        rng.integers(8000, 40000, 300).astype(np.uint16)
    shifts = rng.integers(-20, 21, (f, 2)).astype(np.int32)
    shifts[0] = 0
    frames = np_align(np.broadcast_to(sky, (f, h, w)), shifts[:, 0], shifts[:, 1])
    frames += rng.integers(0, 40, (f, h, w), dtype=np.uint16)
    return frames, shifts


@pytest.mark.cuda
def test_cuda_register_and_stack_matches_cpu_route(cuda_device):
    """The planetary sequence, 1000 x 480 x 640, winsorized (3, 3): on the
    card one align launch, and the shifts, the aligned frames and the stack
    the same words as the CPU route's (its stack, a pixel at a time in
    effect, over bands of rows at the top, middle and bottom)."""
    f, h, w = 1000, 480, 640
    sel, sig = (192, 112, 256), (3.0, 3.0)
    host, drift = drifting_sky(f, h, w, seed=2026)
    frames = frames_from_numpy(host, cuda_device)
    before = launches()
    img, shifts, _ = trs.register_and_stack(frames, sel=sel,
                                            rejection="winsorized", sig=sig)
    assert launches() == before + 1
    np.testing.assert_array_equal(shifts, -drift)
    del frames
    torch.cuda.empty_cache()

    cpu = frames_from_numpy(host, "cpu")
    sx, sy = trs.compute_shifts(cpu, 0, sel)
    np.testing.assert_array_equal(sx.numpy(), shifts[:, 0])
    np.testing.assert_array_equal(sy.numpy(), shifts[:, 1])
    aligned = trs.align_frames_auto(cpu, sx, sy)
    assert launches() == before + 1
    card = trs.align_frames_auto(frames_from_numpy(host, cuda_device),
                                 torch.from_numpy(shifts[:, 0]).to(cuda_device),
                                 torch.from_numpy(shifts[:, 1]).to(cuda_device))
    np.testing.assert_array_equal(u16_to_numpy(card), u16_to_numpy(aligned))
    for r0 in (0, h // 2 - 4, h - 8):
        band = aligned[:, r0:r0 + 8].reshape(f, -1)
        want = trs.stack_rejected(band, "winsorized", sig).reshape(8, w)
        np.testing.assert_array_equal(img[r0:r0 + 8], u16_to_numpy(want))
