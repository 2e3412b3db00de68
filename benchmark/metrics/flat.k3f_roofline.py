"""flat.k3f_roofline: the flat scan's K3f against its bound, in percent.

K3f's device time per traced call (kernels in the port's ``msann_k3f``
namespace) against the least time of the bf16 scan of a batch over the
whole base, a head of k·oversample kept a query."""

from benchmark.harness import roofline


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    t = run.trace.kernel_seconds(lambda n: "msann_k3f::" in n)
    if t <= 0:
        return None
    w, s = run.config["world"], run.config["serve"]
    bound, _ = roofline.score_select_bound(
        int(run.traffic["batch"]), int(w["n_base"]), int(w["dim"]),
        int(s["k"]) * int(s["oversample"]))
    return roofline.share_pct(bound, t / run.trace.calls)
