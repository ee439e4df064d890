"""The port's sparse frontend (``ops/features.py``) against the JAX package's
on the CPU, on the same seeded uint8 images: a blurred random texture and a
planar-sequence frame at 240×320, and one full 480×752 frame.

Tolerances: exact for the FAST score map, the keypoints (slots, scores,
validity, including a constructed field of tied scores), the patches,
``hamming_matrix`` (including all-ones words), ``match_desc`` and
``match``; orientation to atol 1e-6 rad (``atan2`` of the same exact
integer moments, one ulp apart at most); descriptors exact on every
keypoint whose steering bin agrees, with bins differing on ≤ 1 % of
keypoints; ``descriptor_signature`` to atol 1e-6.  The port's descriptor
words are int32 bit patterns of JAX's uint32 words."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.ops import features as J
except ImportError:   # a machine without the JAX reference runs the card test only
    jax = jnp = J = None
from ros_gpu_stereo_processor_tpu_torch.ops import features as T
from ros_gpu_stereo_processor_tpu_torch.utils.synth import _gaussian_blur, render_planar

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(J is None, reason="needs the JAX reference package")


def _texture(H, W, seed):
    rng = np.random.default_rng(seed)
    return _gaussian_blur(rng.integers(0, 255, (H, W), np.uint8), 5, 1.0)


@pytest.fixture(scope="module")
def images():
    lefts, _, _ = render_planar(2, 320, 240, 300.0, 0.1, 3.0, 10.0, 1, 0.25)
    return {"texture": _texture(240, 320, 0), "planar": lefts[0],
            "planar_next": lefts[1], "full": _texture(480, 752, 1)}


@pytest.fixture(scope="module")
def keypoints(images):
    """(JAX Keypoints, port Keypoints) per image, k = 256 (512 at full size)."""
    out = {}
    for name, img in images.items():
        k = 512 if name == "full" else 256
        out[name] = (J.detect_and_describe(jnp.asarray(img), k=k),
                     T.detect_and_describe(torch.from_numpy(img), k=k))
    return out


def _u32(desc: torch.Tensor) -> np.ndarray:
    return desc.numpy().view(np.uint32)


NAMES = ["texture", "planar", "full"]


@needs_jax
@pytest.mark.parametrize("name", NAMES)
def test_fast_score_map_exact(images, name):
    img = images[name]
    want = np.asarray(jax.jit(J.fast_score_map)(jnp.asarray(img)))
    got = T.fast_score_map(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 100


@needs_jax
@pytest.mark.parametrize("threshold", [12.0, 20.5])
def test_fast_score_map_thresholds(images, threshold):
    img = images["planar"]
    np.testing.assert_array_equal(
        T.fast_score_map(torch.from_numpy(img), threshold).numpy(),
        np.asarray(jax.jit(J.fast_score_map, static_argnums=1)(jnp.asarray(img), threshold)))


@needs_jax
@pytest.mark.parametrize("name", NAMES)
def test_keypoints_exact(keypoints, name):
    jk, tk = keypoints[name]
    for f in ("xy", "score", "valid"):
        np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)), err_msg=f)
    assert tk.valid.sum() > 100


@needs_jax
@pytest.mark.parametrize("k", [5, 64, 300])
def test_select_keypoints_stable_on_ties(k):
    """Integer scores from {0, 1, 2, 3}: most slots tie, so the order is set
    by the tie rule (lower flat index first), as ``jax.lax.top_k`` orders."""
    rng = np.random.default_rng(k)
    score = rng.integers(0, 4, (40, 56)).astype(np.float32)
    score[rng.random((40, 56)) < 0.9] = 0.0
    want = J.select_keypoints(jnp.asarray(score), k)
    got = T.select_keypoints(torch.from_numpy(score), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@needs_jax
def test_patches_exact(images, keypoints):
    img = images["planar"]
    jk, _ = keypoints["planar"]
    xy = np.asarray(jk.xy)
    np.testing.assert_array_equal(
        T.extract_patches(torch.from_numpy(img), torch.from_numpy(xy)).numpy(),
        np.asarray(jax.jit(J.extract_patches)(jnp.asarray(img), jnp.asarray(xy))))


@needs_jax
@pytest.mark.parametrize("name", NAMES)
def test_orientation_and_descriptors(keypoints, name):
    jk, tk = keypoints[name]
    np.testing.assert_allclose(tk.angle.numpy(), np.asarray(jk.angle), rtol=0, atol=1e-6)
    # the steering bins as the JAX engine's compiled code computes them
    bins_j = np.asarray(jax.jit(lambda a: jnp.round(jnp.mod(a, 2 * np.pi) / (2 * np.pi) * 16)
                                .astype(jnp.int32) % 16)(jk.angle))
    bins_t = T._steering_bins(tk.angle).numpy()
    same = bins_j == bins_t
    assert (~same).mean() <= 0.01, f"{(~same).sum()} steering bins differ"
    np.testing.assert_array_equal(_u32(tk.desc)[same], np.asarray(jk.desc)[same])


@needs_jax
def test_descriptors_from_the_same_angles_exact(images, keypoints):
    """Given JAX's own angles, the port's steering and packing are exact."""
    img = images["full"]
    jk, _ = keypoints["full"]
    got = T.describe(torch.from_numpy(img), torch.from_numpy(np.asarray(jk.xy)),
                     torch.from_numpy(np.asarray(jk.angle)))
    np.testing.assert_array_equal(_u32(got), np.asarray(jk.desc))


def _words(seed, n=48):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF                     # all-ones words
    w[1] = 0
    w[2, ::2] = 0xFFFFFFFF
    w[3] = 0x80000000                     # only the sign bit of the int32 view
    return w


@needs_jax
def test_hamming_matrix_exact():
    a, b = _words(0), _words(1, 40)
    b[5] = 0xFFFFFFFF
    want = np.asarray(jax.jit(J.hamming_matrix)(jnp.asarray(a), jnp.asarray(b)))
    got = T.hamming_matrix(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 5] == 0 and want[1, 5] == 256


@needs_jax
@pytest.mark.parametrize("max_distance,ratio", [(64, 0.9), (100, 0.8), (256, 1.0)])
def test_match_desc_exact(max_distance, ratio):
    rng = np.random.default_rng(max_distance)
    a = _words(2, 64)
    b = a[rng.permutation(64)].copy()
    flips = rng.integers(0, 2**32, b.shape, dtype=np.uint64).astype(np.uint32)
    b ^= flips & rng.integers(0, 2**32, b.shape, dtype=np.uint64).astype(np.uint32) & 0x01010101
    va, vb = rng.random(64) < 0.9, rng.random(64) < 0.85
    want = jax.jit(J.match_desc, static_argnames=("max_distance", "ratio"))(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
        max_distance=max_distance, ratio=ratio)
    got = T.match_desc(torch.from_numpy(a.view(np.int32)), torch.from_numpy(va),
                       torch.from_numpy(b.view(np.int32)), torch.from_numpy(vb),
                       max_distance=max_distance, ratio=ratio)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).sum() > 10


@needs_jax
def test_match_exact_and_batched(keypoints):
    """Frame-to-frame matching exact; the batched form (a leading pair
    axis, loop closure's) equals the per-pair calls."""
    jk, tk = keypoints["planar"]
    jn, tn = keypoints["planar_next"]
    want = J.match(jk, jn)
    got = T.match(tk, tn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).sum() > 50
    idx, ok = T.match_desc(torch.stack([tk.desc, tn.desc]), torch.stack([tk.valid, tn.valid]),
                           torch.stack([tn.desc, tk.desc]), torch.stack([tn.valid, tk.valid]))
    back = T.match(tn, tk)
    for g, w in ((idx[0], got[0]), (ok[0], got[1]), (idx[1], back[0]), (ok[1], back[1])):
        assert torch.equal(g, w)


@needs_jax
def test_descriptor_signature(keypoints):
    sigs = []
    for name in ("texture", "planar"):
        jk, tk = keypoints[name]
        want = np.asarray(jax.jit(J.descriptor_signature)(jk.desc, jk.valid))
        got = T.descriptor_signature(tk.desc, tk.valid)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        sigs.append(got)
    batched = T.descriptor_signature(
        torch.stack([keypoints[n][1].desc for n in ("texture", "planar")]),
        torch.stack([keypoints[n][1].valid for n in ("texture", "planar")]))
    torch.testing.assert_close(batched, torch.stack(sigs), rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_features_on_cuda_match_cpu(images):
    """The card's sparse frontend against the CPU's on the same frames:
    keypoints and patches exact, angles to 1e-6, descriptors exact where
    the steering bins agree (≤ 1 % differ), matches exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    kps = {}
    for name in ("planar", "planar_next", "full"):
        img = torch.from_numpy(images[name])
        k = 512 if name == "full" else 256
        cpu = T.detect_and_describe(img, k=k)
        gpu = T.detect_and_describe(img.to(dev), k=k)
        torch.cuda.synchronize()
        for f in ("xy", "score", "valid"):
            assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
        torch.testing.assert_close(gpu.angle.cpu(), cpu.angle, rtol=0, atol=1e-6)
        same = T._steering_bins(gpu.angle).cpu() == T._steering_bins(cpu.angle)
        assert (~same).float().mean() <= 0.01
        assert torch.equal(gpu.desc.cpu()[same], cpu.desc[same])
        kps[name] = (cpu, gpu)
    (ca, ga), (cb, gb) = kps["planar"], kps["planar_next"]
    for g, c in zip(T.match(ga, gb), T.match(ca, cb)):
        assert torch.equal(g.cpu(), c)
