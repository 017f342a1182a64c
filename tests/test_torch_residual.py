"""Port residual path vs the JAX package's: `residual_bucket` (dequant +
inverse DCT/DST, transform skip, bypass, RDPCM) and `_residual_acc`
(payload unpack, escapes, slot scatter) on the same inputs. Tolerance:
none (integer outputs, exact equality)."""
import numpy as np
import pytest
import torch

from test_torch_parse import parsed_port, stream


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_residual_bucket_matches_jax(s, bd):
    import jax.numpy as jnp
    from openhevc_tpu.ops.idct import residual_bucket as jax_rb
    from openhevc_tpu_torch.ops.idct import residual_bucket
    rng = np.random.default_rng(s * 100 + bd)
    n = 4 * 52                                    # every qp 0..51, 4 times
    lv = rng.integers(-200, 200, (n, s, s)).astype(np.int32)
    lv[::7] = rng.integers(-32768, 32767, (len(lv[::7]), s, s))
    lv[::5] *= rng.random((len(lv[::5]), s, s)) < 0.1   # sparse blocks
    qp = np.tile(np.arange(52, dtype=np.int32), 4)
    mode = rng.integers(0, 6, n)       # 0 dct 1 dst 2 ts 3 bypass 4/5 rdpcm
    is_dst = (mode == 1) & (s == 4)
    tskip = (mode == 2) | (mode == 4)
    bypass = (mode == 3) | (mode == 5)
    has_rdpcm = mode >= 4
    vert = rng.random(n) < 0.5
    flags = (is_dst, tskip, bypass, vert, has_rdpcm)
    want = np.asarray(jax_rb(jnp.asarray(lv), jnp.asarray(qp),
                             *(jnp.asarray(f) for f in flags),
                             s=s, bit_depth=bd))
    got = residual_bucket(torch.from_numpy(lv), torch.from_numpy(qp),
                          *(torch.from_numpy(f) for f in flags),
                          s=s, bit_depth=bd)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_residual_acc_matches_jax():
    """Real native packs: nibble-mode and byte-mode TUs, escapes with
    their (-1, -1) padding pairs, and the FAR padding rows."""
    import jax.numpy as jnp
    from openhevc_tpu.models.pipeline import _residual_acc as jax_acc
    from openhevc_tpu_torch.models.pipeline import _residual_acc
    seen = {"nibble": False, "byte": False, "esc_pad": False, "far": False}
    for name in ("plain", "dense", "wpp"):
        data, _ = stream(name)
        for fs in parsed_port(data):
            npk, sps = fs.native_pack, fs.sps
            H, W = sps.height, sps.width
            Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
            a4, a16, esc = npk["arena4"], npk["arena16"], npk["esc"]
            off = 0
            for _s, cap, _sm, _ne in npk["caps"]:
                if cap:
                    cw = a16[off + 3 * cap:off + 4 * cap]
                    seen["byte"] |= bool((cw >> 12 & 1).any())
                    seen["nibble"] |= bool(((cw >> 12 & 1) == 0).any())
                    seen["far"] |= bool((a16[off:off + cap] < 0).any())
                    off += 4 * cap
            seen["esc_pad"] |= bool((esc == -1).any())
            kw = dict(caps=npk["caps"], H=H, W=W, Hc=Hc, Wc=Wc,
                      bd=sps.bit_depth)
            wl, wc = jax_acc(jnp.asarray(a4), jnp.asarray(a16),
                             jnp.asarray(esc), **kw)
            gl, gc = _residual_acc(torch.from_numpy(a4),
                                   torch.from_numpy(a16),
                                   torch.from_numpy(esc), **kw)
            assert np.array_equal(gl.numpy(), np.asarray(wl)[:H, :W])
            assert np.array_equal(gc.numpy(),
                                  np.asarray(wc)[:, :Hc, :Wc])
    assert all(seen.values()), seen
