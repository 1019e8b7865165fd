"""sam_boxes.segment: the boxes SAM decodes a request (count), the program's
``seg_boxes`` counter over the requests the tracer saw. None where the
program has no such counter."""


def read(rec):
    counters, n = rec.get("program_counters"), rec.get("traced_requests")
    if not counters or not n or "seg_boxes" not in counters:
        return None
    return counters["seg_boxes"] / n
