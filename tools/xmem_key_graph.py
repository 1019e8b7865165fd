"""XMem's key encoder (``XMem.encode_key``: ResNet-50 to stride 16 and the
key, shrinkage and selection projections) at the video cell's shape, one
480x864 frame, eager (``encode_key_eager``) against a replay of its CUDA
graph, in bf16 and in f32 (TF32 off), with the benchmark's weights.

For each: the capture's call (ms, synchronised), a call's median with a
synchronise after each (what the cell's ``xmem_key`` span reads), the
host's time to issue one call and the device's time a call over 50 calls
back to back (CUDA events), and the device ops of one call in a
``torch.profiler`` trace. Prints one JSON object. Needs a CUDA card.

    python tools/xmem_key_graph.py
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from d3fields_tpu_torch.config import XMemConfig  # noqa: E402
from d3fields_tpu_torch.models.common import cast_copy  # noqa: E402
from d3fields_tpu_torch.models.xmem.network import XMem  # noqa: E402
from d3fields_tpu_torch.utils.convert import audit_state_dict  # noqa: E402
from port_bench import weights_xmem  # noqa: E402

SHAPE = (1, 3, 480, 864)
N = 50


def model_in(dtype: torch.dtype, dev) -> XMem:
    cfg = XMemConfig(key_dim=64, value_dim=512, hidden_dim=64)
    model = XMem(cfg, device=dev)
    xmem = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "compute_dtype"}
    sd = weights_xmem.xmem_weights(xmem, 2 ** 33 + 1, dev)
    model.load_state_dict(audit_state_dict(model, sd, "xmem"), strict=True)
    return cast_copy(model.eval(), dtype)


def device_ops(fn, img) -> int:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(img)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def timings(fn, imgs) -> dict:
    synced = []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(imgs[i % len(imgs)])
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(N):
        fn(imgs[i % len(imgs)])
    end.record()
    issue = (time.perf_counter() - t0) * 1e3 / N
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / N
    return {"synced_ms_median": statistics.median(synced), "issue_ms": issue,
            "wall_ms": wall, "device_ms": start.elapsed_time(end) / N,
            "device_ops": device_ops(fn, imgs[0])}


@torch.no_grad()
def main() -> None:
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["power_limit"] = smi.stdout.strip()
    for dtype in (torch.bfloat16, torch.float32):
        model = model_in(dtype, dev)
        imgs = [torch.randn(SHAPE, device=dev, generator=gen).to(dtype) for _ in range(4)]
        for _ in range(3):
            model.encode_key_eager(imgs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode_key(imgs[0])
        torch.cuda.synchronize()
        row = {"capture_ms": (time.perf_counter() - t0) * 1e3,
               "eager": timings(model.encode_key_eager, imgs),
               "graph": timings(model.encode_key, imgs)}
        row["equal"] = all(torch.equal(a, b) for a, b in
                           zip(model.encode_key(imgs[1]), model.encode_key_eager(imgs[1])))
        out[str(dtype).split(".")[1]] = row
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
