"""sam_attn_launches.segment: launches of SAM's attention kernel a request
(count), the program's ``sam_attn`` counter over the requests the tracer
saw: one a vision layer of the encode, 32 for ViT-H. None where the program
has no such counter."""


def read(rec):
    counters, n = rec.get("program_counters"), rec.get("traced_requests")
    if not counters or not n or "sam_attn" not in counters:
        return None
    return counters["sam_attn"] / n
