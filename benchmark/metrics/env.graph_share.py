"""Share of the traced env steps that replayed their post-physics chain as
one CUDA graph: 100 x the ``parc.env.graph_replay`` markers over the
``parc.env.step`` spans in the traced window (harness/spans). None where no
``parc.env.step`` span was traced; 0 where every step ran the chain
eagerly."""

from harness import spans


def read(run):
    steps = spans.count(run, "parc.env.step")
    if not steps:
        return None
    return 100.0 * spans.count(run, "parc.env.graph_replay") / steps
