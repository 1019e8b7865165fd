"""xmem_read_elements.video: the memory elements a frame's read attends,
[long-term, working], averaged over the frames (count): the program's
``xmem_read_elements`` counter over its ``xmem_frames`` counter, over the
frames the tracer saw (seed frames read nothing). None where the program
has no such counters."""


def read(rec):
    counters = rec.get("program_counters")
    if not counters or not counters.get("xmem_frames") or "xmem_read_elements" not in counters:
        return None
    return counters["xmem_read_elements"] / counters["xmem_frames"]
