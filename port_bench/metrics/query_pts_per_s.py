"""query_pts_per_s: every point answered in the window over the window's time (pts/s)."""


def read(rec):
    return rec["work"] / rec["window_s"] if rec.get("window_s") else None
