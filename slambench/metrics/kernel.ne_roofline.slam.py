"""kernel.ne_roofline.slam: the normal-equations kernel's share of its
roofline over the traced window, %: the stream's registration and the
closure verification of every pass.

The least time the card could take for the window's NE calls is the
larger of their bytes over the HBM peak and their operations over the
float64 peak (`lib/counts.py`, from each call's shape (F, P) and its hit
count, `lib/peaks.py`); the share is that over the kernel's device time
in the trace (the kernels `ne_kernel<...>` of csrc/normal_equations.cu).
The shapes and hit counts are recorded, in the traced run only, by a
wrapper around the port's launch function that keeps a reference to each
call's `n_hit` output (no device work, no wait) and reads them after the
window.
"""

from slambench.lib import counts, peaks
from slambench.lib import trace as tr

KERNEL = "::ne_kernel<"


def install(ctx):
    from veloslam_tpu_torch.registration import normal_equations as ne
    calls = []
    orig = ne._launch

    def launch(pts, q, t, mu, n, hit, *a, **k):
        out = orig(pts, q, t, mu, n, hit, *a, **k)
        n_hit = out.n_hit if hasattr(out, "n_hit") else out[4]
        calls.append((int(hit.shape[0]), int(hit.shape[1]), n_hit))
        return out

    ne._launch = launch
    ctx.probes["ne"] = {"calls": calls, "orig": orig, "module": ne}


def uninstall(ctx):
    p = ctx.probes.get("ne")
    if p is not None:
        p["module"]._launch = p["orig"]


def read(ctx):
    p = ctx.probes.get("ne")
    if p is None or ctx.trace is None or not p["calls"]:
        return None
    dev_s, n_kernels = tr.kernel_seconds(ctx.trace, KERNEL)
    if dev_s <= 0:
        return None
    nbytes = flops = 0
    for F, P, n_hit in p["calls"]:
        hits = int(n_hit.sum().item())
        nbytes += counts.ne_bytes(F, P, hits)
        flops += counts.ne_flops(hits)
    floor_s = max(nbytes / peaks.HBM_BYTES_PER_S,
                  flops / peaks.FP64_FLOP_PER_S)
    ctx.notes["kernel.ne_roofline.slam"] = {
        "calls": len(p["calls"]), "kernels": n_kernels, "device_s": dev_s,
        "bytes": nbytes, "flops": flops,
        "bound": ("bytes" if nbytes / peaks.HBM_BYTES_PER_S
                  >= flops / peaks.FP64_FLOP_PER_S else "flops")}
    return 100.0 * floor_s / dev_s
