"""The port's distributed FFT (``waveforms_tpu_torch.ops.fft_sharded``)
against the JAX package's four-step FFT on its 8-device CPU mesh.

The same rows go through JAX's ``fft_sharded`` / ``ifft_sharded`` under
``shard_map`` on a ('time',) mesh of the 8 virtual CPU devices (as
tests/test_ops_iir_fft.py runs them) and through the port's, whose shards
are blocks on a mesh that names the CPU P times: the strided spectrum
blocks within 1e-12 of JAX's in complex128 (of the spectrum's peak), the
round trip and the circular convolutions within 1e-12 of numpy's in
float64, complex64 within JAX's own bounds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
import waveforms_tpu.ops.fft_sharded as fj
from waveforms_tpu_torch.ops import fft_convolve_sharded
from waveforms_tpu_torch.ops.fft_sharded import fft_sharded, ifft_sharded
from waveforms_tpu_torch.parallel.mesh import channel_mesh

TOL = 1e-12


def time_mesh(P):
    return channel_mesh(1, P, devices=['cpu'] * P)


def blocks_of(x, P, dtype=torch.complex128):
    L = x.shape[-1] // P
    return [torch.from_numpy(x[..., r * L:(r + 1) * L]).to(dtype)
            for r in range(P)]


@pytest.mark.parametrize('P', [2, 4, 8])
def test_spectrum_blocks_match_jax_and_numpy(P):
    rng = np.random.default_rng(3)
    N = P * P * 64
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    got = fft_sharded(blocks_of(x, P))
    mesh = Mesh(np.array(jax.devices()[:P]), ('time',))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=PS('time'),
                       out_specs=PS('time'))
    def fwd(xl):
        return fj.fft_sharded(xl, 'time')

    ref = np.asarray(fwd(jax.device_put(jnp.asarray(x, jnp.complex128),
                                        NamedSharding(mesh, PS('time')))))
    want = np.fft.fft(x)
    peak = np.abs(want).max()
    L = N // P
    for p, blk in enumerate(got):
        assert np.abs(blk.numpy() - ref[p * L:(p + 1) * L]).max() <= (
            TOL * peak)
        assert np.abs(blk.numpy() - want[p::P]).max() <= TOL * peak
    back = torch.cat(ifft_sharded(got), -1).numpy()
    assert np.abs(back - x).max() <= TOL * np.abs(x).max()


def test_batched_rows_transform_independently():
    """Blocks of shape (rows, L): each row is its own transform."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4 * 4 * 32))
    got = fft_sharded(blocks_of(x, 4))
    want = np.fft.fft(x, axis=-1)
    for p, blk in enumerate(got):
        assert np.abs(blk.numpy() - want[:, p::4]).max() <= (
            TOL * np.abs(want).max())


@pytest.mark.parametrize('P', [2, 8])
def test_convolution_f64_matches_numpy_and_jax(P):
    rng = np.random.default_rng(7)
    N = P * P * 32
    x = rng.standard_normal((4, N))
    ker = rng.standard_normal(17)
    plane = fft_convolve_sharded(torch.from_numpy(x), ker, time_mesh(P))
    assert len(plane.blocks[0]) == P
    got = plane.gather().numpy()
    assert got.dtype == np.float64 and got.shape == x.shape
    want = np.fft.ifft(np.fft.fft(x) * np.fft.fft(ker, n=N)).real
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    mesh = Mesh(np.array(jax.devices()[:P]), ('time',))
    ref = np.asarray(fj.fft_convolve_sharded(jnp.asarray(x[0], jnp.float64),
                                             ker, mesh))
    assert np.abs(got[0] - ref).max() <= TOL * np.abs(ref).max()


def test_convolution_f32_within_jax_bounds():
    """An f32 signal runs in complex64: the JAX suite's bounds (round trip
    1e-4, convolution 2e-3), and JAX's own result within the same."""
    rng = np.random.default_rng(3)
    N = 8 * 8 * 64
    x = rng.standard_normal(N)
    ker = rng.standard_normal(33)
    sig = torch.from_numpy(x).float()
    got = fft_convolve_sharded(sig, ker, time_mesh(8)).gather().numpy()
    assert got.dtype == np.float32
    want = np.fft.ifft(np.fft.fft(x) * np.fft.fft(ker, n=N)).real
    assert np.abs(got - want).max() < 2e-3
    back = torch.cat(ifft_sharded(fft_sharded(blocks_of(
        x, 8, torch.complex64))), -1).real.numpy()
    assert np.abs(back - x).max() < 1e-4
    mesh = Mesh(np.array(jax.devices()[:8]), ('time',))
    ref = np.asarray(fj.fft_convolve_sharded(jnp.asarray(x, jnp.float32),
                                             ker, mesh))
    assert np.abs(got - ref).max() < 2e-3


def test_centered_alignment():
    """centered=True treats the kernel's zero-lag as its center tap: a
    centered identity kernel returns the signal (the JAX suite's
    test_fft_convolve_sharded_centered_alignment), and a 31-tap Hann
    kernel equals numpy's circular convolution with the rolled kernel."""
    rng = np.random.default_rng(2)
    sig = rng.standard_normal(1024)
    ker = np.zeros(33)
    ker[16] = 1.0
    out = fft_convolve_sharded(torch.from_numpy(sig), ker, time_mesh(4),
                               centered=True).gather().numpy()
    assert np.abs(out - sig).max() <= TOL
    hann = np.hanning(31)
    rolled = np.roll(np.concatenate([hann, np.zeros(1024 - 31)]), -15)
    want = np.fft.ifft(np.fft.fft(sig) * np.fft.fft(rolled)).real
    out = fft_convolve_sharded(torch.from_numpy(sig), hann, time_mesh(4),
                               centered=True).gather().numpy()
    assert np.abs(out - want).max() <= TOL * np.abs(want).max()


def test_refusals():
    sig = torch.zeros(1000, dtype=torch.float64)
    with pytest.raises(ValueError, match='multiple of P'):
        fft_convolve_sharded(sig, np.ones(3), time_mesh(4))
    with pytest.raises(ValueError, match='longer than the signal'):
        fft_convolve_sharded(torch.zeros(64, dtype=torch.float64),
                             np.ones(65), time_mesh(4))
    with pytest.raises(ValueError, match='multiple of 4'):
        fft_sharded(blocks_of(np.zeros(4 * 30), 4))
