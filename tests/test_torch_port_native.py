"""The port's native host data runtime (data/native.py, built from
native/tvae_native.cpp into targetvae_tpu_torch/build/) against the JAX
package's binding of the same library and against numpy: bitwise equal
stacks and gathers (the same C code, and numpy's float32 copies), and a
failed build that raises with the compiler's message instead of falling
back."""

import numpy as np
import pytest

from targetvae_tpu_torch.data import mrc, native
from targetvae_tpu_torch.data.datasets import load_particles


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mrc") / "stack.mrcs")
    arr = np.random.RandomState(0).randn(40, 22, 22).astype(np.float32)
    mrc.write(path, arr)
    return path, arr


def test_library_builds_into_the_port(stack):
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.SOURCE.name == "tvae_native.cpp"
    info = native.mrc_info(stack[0])
    assert (info.nz, info.ny, info.nx, info.mode) == (40, 22, 22, 2)


@pytest.mark.parametrize("crop,normalize", [(0, False), (16, True),
                                            (16, False), (0, True)])
def test_load_matches_jax_native(stack, crop, normalize):
    """Plain, and centre crop plus per-image standardisation: bitwise the
    JAX package's native load; the plain stack bitwise the file's floats;
    the numpy path (native=False) within float32 rounding of the mean and
    std's sums."""
    from targetvae_tpu.data import native as jax_native
    path, arr = stack
    got = native.load_mrc_f32(path, crop=crop, normalize=normalize)
    ref = jax_native.load_mrc_f32(path, crop=crop, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if not crop and not normalize:
        np.testing.assert_array_equal(got, arr)
    plain = native.load_mrc_f32(path, crop=crop, normalize=normalize,
                                native=False)
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_load_int16_matches_jax_native(tmp_path):
    from targetvae_tpu.data import native as jax_native
    path = str(tmp_path / "i16.mrcs")
    arr = (np.random.RandomState(1).randn(8, 12, 12) * 100).astype(np.int16)
    mrc.write(path, arr)
    got = native.load_mrc_f32(path)
    np.testing.assert_array_equal(got, jax_native.load_mrc_f32(path))
    np.testing.assert_array_equal(got, arr.astype(np.float32))


@pytest.mark.parametrize("shape", [(40, 22, 22), (30, 7, 7, 3), (9, 5)])
def test_gather_matches_jax_native_and_numpy(shape):
    from targetvae_tpu.data import native as jax_native
    arr = np.random.RandomState(2).randn(*shape).astype(np.float32)
    idx = np.random.RandomState(3).permutation(shape[0])[:17 % shape[0] + 3]
    got = native.gather_f32(arr, idx)
    np.testing.assert_array_equal(got, jax_native.gather_f32(arr, idx))
    np.testing.assert_array_equal(got, arr[idx])
    out = np.empty_like(got)
    assert native.gather_f32(arr, idx, out=out) is out
    np.testing.assert_array_equal(out, arr[idx])
    np.testing.assert_array_equal(native.gather_f32(arr, idx, native=False),
                                  arr[idx])
    with pytest.raises(IndexError):
        native.gather_f32(arr, np.asarray([shape[0]]))


def test_load_particles_reads_through_the_native_loader(stack, monkeypatch):
    path, arr = stack
    calls = []
    orig = native.load_mrc_f32
    monkeypatch.setattr(native, "load_mrc_f32",
                        lambda p, *a, **k: calls.append(p) or orig(p, *a,
                                                                   **k))
    np.testing.assert_array_equal(load_particles(path), arr)
    assert calls == [path]


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source that does not compile: build() raises with g++'s message,
    leaves no library behind, and the entry points raise too, rather than
    falling back to numpy."""
    bad = tmp_path / "tvae_native.cpp"
    bad.write_text("extern \"C\" int tvae_gather_f32( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            native.build(bad)
        assert not list((tmp_path / "build").glob("*.so"))
        with pytest.raises(RuntimeError, match="failed to build"):
            native.gather_f32(np.zeros((4, 3), np.float32), np.arange(2))
    finally:
        native.library.cache_clear()
