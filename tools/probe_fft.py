"""Probe: FFT-based azimuthal transform vs the dense real-DFT matmul.

Questions (A/B inside one process on one card):
1. Does jnp.fft.rfft/irfft lower on the device?
2. Accuracy: coefficient/value error vs the float64 dense reference, at
   f32 — is it at least as good as the compensated-bf16 matmul path?
3. Speed: synthesis+analysis round trip (values -> masked coeffs ->
   values) across nl in {256, 512, 1024, 2048, 4096} on a flagship-like
   batch, FFT vs dense-compensated, chained on device.

The real-coefficient layout must match basis/fourier.py:
    [mean, cos(1..nl/2), sin(1..nl/2-1)].
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def pack_rfft(X, nl):
    """complex rfft output [.., nl//2+1] -> real coeff layout [.., nl]."""
    import jax.numpy as jnp

    half = nl // 2
    c0 = X[..., :1].real / nl
    cos_mid = 2.0 * X[..., 1:half].real / nl
    cos_half = X[..., half : half + 1].real / nl
    sin_mid = -2.0 * X[..., 1:half].imag / nl
    return jnp.concatenate([c0, cos_mid, cos_half, sin_mid], axis=-1)


def unpack_to_rfft(c, nl):
    """real coeff layout [.., nl] -> complex rfft array [.., nl//2+1]."""
    import jax.numpy as jnp

    half = nl // 2
    c0 = c[..., :1]
    cos_mid = c[..., 1:half]
    cos_half = c[..., half : half + 1]
    sin_mid = c[..., half + 1 :]
    X0 = (c0 * nl).astype(jnp.complex64)
    Xmid = (cos_mid - 1j * sin_mid) * (nl / 2.0)
    Xh = (cos_half * nl).astype(jnp.complex64)
    return jnp.concatenate([X0, Xmid.astype(jnp.complex64), Xh], axis=-1)


def main():
    import jax
    import jax.numpy as jnp

    from scythe_tpu.basis import fourier
    from scythe_tpu.grids.base import _split3, Grid

    from scythe_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print("device:", dev.platform, dev.device_kind)

    rng = np.random.default_rng(0)
    batch = 6 * 300  # flagship-like [nvars * rDim]

    for nl in [256, 512, 1024, 2048, 4096]:
        x64 = rng.normal(size=(batch, nl))
        x = jnp.asarray(x64, jnp.float32)

        # float64 dense reference
        la, ls, ld, ld2 = fourier.dft_matrices(nl)
        ref_c = x64 @ la.T
        ref_v = ref_c @ ls.T

        # --- FFT path -------------------------------------------------
        def fft_round(x):
            X = jnp.fft.rfft(x, axis=-1)
            c = pack_rfft(X, nl)
            Xb = unpack_to_rfft(c, nl)
            return c, jnp.fft.irfft(Xb, n=nl, axis=-1)

        fr = jax.jit(fft_round)
        c_f, v_f = fr(x)
        jax.block_until_ready(v_f)
        err_c = float(
            jnp.abs(c_f - ref_c).max() / (np.abs(ref_c).max() + 1e-30)
        )
        err_v = float(
            jnp.abs(v_f - ref_v).max() / (np.abs(ref_v).max() + 1e-30)
        )

        # --- dense compensated path ----------------------------------
        class MM:
            comp = True
            dtype = jnp.float32
        mm = Grid._mm.__get__(MM(), MM)
        la3, ls3 = _split3(la), _split3(ls)

        def dense_round(x):
            c = mm("kl,bl->bk", la3, x)
            return c, mm("lk,bk->bl", ls3, c)

        dr_ = jax.jit(dense_round)
        c_d, v_d = dr_(x)
        jax.block_until_ready(v_d)
        err_cd = float(
            jnp.abs(c_d - ref_c).max() / (np.abs(ref_c).max() + 1e-30)
        )
        err_vd = float(
            jnp.abs(v_d - ref_v).max() / (np.abs(ref_v).max() + 1e-30)
        )

        # --- speed: chained round trips ------------------------------
        # NB a host fetch closes the timed region.
        L = 200

        def chain(f):
            def run(x0):
                def body(c, _):
                    _, v = f(c)
                    return v, None

                out, _ = jax.lax.scan(body, x0, None, length=L)
                return out[0, 0]

            g = jax.jit(run)
            float(g(x))
            best = np.inf
            for _ in range(4):
                t0 = time.time()
                float(g(x))
                best = min(best, time.time() - t0)
            return best / L

        t_fft = chain(fft_round)
        t_dense = chain(dense_round) if nl <= 2048 else np.inf
        print(
            f"nl={nl:5d}  err(fft c/v)={err_c:.2e}/{err_v:.2e}  "
            f"err(dense c/v)={err_cd:.2e}/{err_vd:.2e}  "
            f"t_fft={t_fft*1e6:8.1f}us  t_dense={t_dense*1e6:8.1f}us  "
            f"speedup={t_dense/t_fft:5.2f}x"
        )


if __name__ == "__main__":
    main()
