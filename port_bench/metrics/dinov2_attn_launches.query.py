"""dinov2_attn_launches.query: launches of the attention kernel
(csrc/sam_attention.cu, either route) inside the feature backend's
``pb.dinov2`` range, a request (count), over the profiled requests: one a
DINOv2 layer, 24 for ViT-L. None where the profile holds no such launch (a
program whose DINOv2 attention is a chain of library ops)."""
import re

PATTERN = re.compile(r"sam_attention_(bf16|f32)_kernel")


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["steps"]:
        return None
    n = sum(1 for name, _, span in prof["ops"] if span == "dinov2" and PATTERN.search(name))
    return n / prof["steps"] if n else None
