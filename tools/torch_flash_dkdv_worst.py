#!/usr/bin/env python3
"""Show where the port's dK/dV kernel comes nearest its phase-3 limit.

Runs ``chip_smoke.py``'s phase 3 (``phase_kernel``) with its seed, so the
inputs are the ones the drive checks, and stops at the paths' shape (B 8,
H 16, S 2048, D 64, causal) in the dtype given.  There it launches
``flash_bwd_dkdv`` on its route, the same inputs with dout 2 bytes off
16-byte alignment (the register-tiled kernel) and the plain version, and
for dk and dv prints each one's worst error/limit (``chip_smoke.bwd_error``'s
limit), then the elements nearest the limit: the three results, the
element's sum of absolute terms M, and the sum over the queries in
float64 of the terms as each recipe rounds them: p = exp(s * scale -
lse) in float32 (the plain version's), p = exp2(s * scale * log2(e) -
lse * log2(e)) in float32 (the tensor-core kernel's), and p in float64;
with the number of terms whose rounded p (dv) or ds (dk) differs between
the two float32 recipes.  Needs the card.

Usage: python3 tools/torch_flash_dkdv_worst.py [float16|bfloat16] [TOP]
(default float16, 5).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG2E = 1.44269504088896341


class Done(Exception):
    pass


def limit_ratios(torch, chip_smoke, got, want, mag, dtn):
    """Per element, |got - want| over ``bwd_error``'s limit."""
    err = (got.float() - want.float()).abs()
    tol = (2.0 ** -chip_smoke.BWD_F32_BITS + 2.0 ** -chip_smoke.ULP_BITS[dtn]) \
        * mag + 2 * chip_smoke.ulp(torch, want.float().abs(), dtn)
    return err / tol.clamp_min(1e-30)


def element(torch, q, k, v, do, lse, delta, scale, causal, name, idx):
    """(plain-recipe, kernel-recipe, float64 sum, rounded terms that
    differ between the two float32 recipes) of one dk or dv element."""
    b, h, j, c = idx
    sq, sk = q.shape[2], k.shape[2]
    rows = torch.arange(sq, device=q.device)
    vis = j <= rows + (sk - sq) if causal else torch.ones_like(rows, dtype=torch.bool)
    s32 = q[b, h].float() @ k[b, h, j].float()
    zero = torch.zeros_like(s32)
    p_plain = torch.where(vis, torch.exp(s32 * scale - lse[b, h]), zero)
    p_tc = torch.where(vis, torch.exp2(s32 * (scale * LOG2E)
                                       - lse[b, h] * LOG2E), zero)
    qd, dod = q[b, h].double(), do[b, h].double()
    p64 = torch.where(vis, torch.exp(qd @ k[b, h, j].double() * scale
                                     - lse[b, h].double()), zero.double())
    if name == "dv":
        r_plain, r_tc = p_plain.to(q.dtype), p_tc.to(q.dtype)
        col, exact = dod[:, c], p64 * dod[:, c]
    else:
        dp32 = do[b, h].float() @ v[b, h, j].float()
        r_plain = (p_plain * (dp32 - delta[b, h]) * scale).to(q.dtype)
        r_tc = (p_tc * (dp32 - delta[b, h]) * scale).to(q.dtype)
        col = qd[:, c]
        exact = p64 * (dod @ v[b, h, j].double() - delta[b, h].double()) \
            * scale * col
    return ((r_plain.double() * col).sum().item(),
            (r_tc.double() * col).sum().item(), exact.sum().item(),
            int((r_plain != r_tc).sum().item()))


def analyse(torch, chip_smoke, att, inputs, dtn, top):
    q, k, v, do, o, lse, delta, scale = inputs
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, lse, delta, True, scale)
    route = att._dkdv_route(q.dtype, q.shape[-1], att._aligned16(q, k, v, do))
    sdk, sdv = att.flash_bwd_dkdv(q, k, v, chip_smoke.off16(torch, do), lse,
                                  delta, True, scale)
    pdk, pdv = att._flash_bwd_dkdv_plain(q, k, v, do, lse, delta, True, scale)
    _, m_dk, m_dv = chip_smoke.bwd_magnitudes(torch, att, q, k, v, do, lse,
                                              delta, True, scale)
    torch.cuda.synchronize()
    for name, got, simt, want, mag in (("dk", dk, sdk, pdk, m_dk),
                                       ("dv", dv, sdv, pdv, m_dv)):
        r = limit_ratios(torch, chip_smoke, got, want, mag, dtn)
        rs = limit_ratios(torch, chip_smoke, simt, want, mag, dtn)
        print("%s %s: route %s worst error/limit %.3f (%d elements above 1), "
              "simt %.3f" % (dtn, name, route, r.max().item(),
                             int((r > 1).sum().item()), rs.max().item()),
              flush=True)
        best = torch.topk(r.flatten(), top)
        for ratio, flat in zip(best.values.tolist(), best.indices.tolist()):
            idx = [int(x) for x in torch.unravel_index(torch.tensor(flat),
                                                       r.shape)]
            plain_sum, tc_sum, exact, flips = element(
                torch, q, k, v, do, lse, delta, scale, True, name, idx)
            print("  %s%s %.3f of the limit: %s %.6g, simt %.6g, plain "
                  "%.6g; M %.4g; float64 sums of the rounded terms: plain "
                  "recipe %.6g, kernel recipe %.6g; exact %.6g; %d terms "
                  "rounded differently" % (
                      name, idx, ratio, route, got[tuple(idx)].item(),
                      simt[tuple(idx)].item(), want[tuple(idx)].item(),
                      mag[tuple(idx)].item(), plain_sum, tc_sum, exact,
                      flips), flush=True)


def main(argv):
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from mxnet_tpu_torch.ops import attention as att
    if not torch.cuda.is_available():
        print("torch_flash_dkdv_worst: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dtn = argv[0] if argv else "float16"
    top = int(argv[1]) if len(argv) > 1 else 5
    check_bwd = chip_smoke.check_bwd

    def stop_at_the_path_shape(torch_, att_, inputs, causal, dtn_):
        if tuple(inputs[0].shape) == chip_smoke.PATH_SHAPE[:3] + \
                chip_smoke.PATH_SHAPE[4:] and dtn_ == dtn:
            analyse(torch, chip_smoke, att, inputs, dtn, top)
            raise Done()
        return check_bwd(torch_, att_, inputs, causal, dtn_)
    chip_smoke.check_bwd = stop_at_the_path_shape
    card = chip_smoke.phase_device(torch)
    try:
        chip_smoke.phase_kernel(torch, card, 0)
    except Done:
        return 0
    finally:
        chip_smoke.check_bwd = check_bwd
    print("torch_flash_dkdv_worst: phase 3 ended before the paths' shape",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
