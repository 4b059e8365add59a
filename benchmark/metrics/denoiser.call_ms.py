"""Ms of a replan's device time a denoiser call: the mean ms of a replan
from the CUDA events the benchmark records around each call in the
measured window (as ``parkour.replan_ms``), times the traced window's
``parc.env.replan`` spans, over its ``parc.ddim.denoise`` spans. None
where the program opens no such span."""

from harness import spans


def read(run):
    replan_ms = run.span_ms("replan")
    replans = spans.count(run, "parc.env.replan")
    calls = spans.count(run, "parc.ddim.denoise")
    if replan_ms is None or not replans or not calls:
        return None
    return replan_ms * replans / calls
