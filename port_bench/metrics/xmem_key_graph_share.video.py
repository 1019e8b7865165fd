"""xmem_key_graph_share.video: the share of frames whose key encoder ran as
a replay of a CUDA graph (%), the program's ``xmem_key_graph_replays``
counter over its ``xmem_frames`` counter, over the frames the tracer saw.
None where the program has no such counter."""


def read(rec):
    counters = rec.get("program_counters")
    if not counters or not counters.get("xmem_frames") or "xmem_key_graph_replays" not in counters:
        return None
    return 100.0 * counters["xmem_key_graph_replays"] / counters["xmem_frames"]
