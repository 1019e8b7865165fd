"""dinov2_ffn_ms.query: the summed device time of the ops launched inside the
driver's ``pb.dinov2_ffn`` ranges (each transformer block's feed-forward,
ranged only while the profile records), a request (ms), over the profiled
requests. None where the profile holds no such range (a driver that does
not range the feed-forward)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["steps"]:
        return None
    total = sum(d for _, d, span in prof["ops"] if span == "dinov2_ffn")
    return 1e3 * total / prof["steps"] if total else None
