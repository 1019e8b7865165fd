"""setup_s: process start to the first timed request or frame (s), compilation included."""


def read(rec):
    return rec["setup_s"]
