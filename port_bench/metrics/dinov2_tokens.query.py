"""dinov2_tokens.query: the tokens entering DINOv2's blocks a transformer call
(count), the program's ``dinov2_tokens`` counter over its
``dinov2_forwards`` counter, over the requests the tracer saw: views x (1 +
registers + patches), 3,092 for ViT-g/14-reg on 4 views of 24x32 patches.
None where the program has no such counters."""


def read(rec):
    counters = rec.get("program_counters")
    if not counters or not counters.get("dinov2_forwards") or "dinov2_tokens" not in counters:
        return None
    return counters["dinov2_tokens"] / counters["dinov2_forwards"]
