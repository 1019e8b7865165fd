"""dinov2_graph_share.query: the share of DINOv2 transformer calls that ran
as a replay of a CUDA graph (%), the program's ``dinov2_graph_replays``
counter over its ``dinov2_forwards`` counter, over the requests the tracer
saw. None where the program has no such counter."""


def read(rec):
    counters = rec.get("program_counters")
    if not counters or not counters.get("dinov2_forwards") \
            or "dinov2_graph_replays" not in counters:
        return None
    return 100.0 * counters["dinov2_graph_replays"] / counters["dinov2_forwards"]
