"""DINOv2's transformer (``Dinov2.forward_tokens``: the patch embedding, the
tokens, every block and the final norm) at the query cells' shape, 4 views
of 336x448 (a 24x32 patch grid), eager (``forward_tokens_eager``) against a
replay of its CUDA graph: ViT-L/14 in f32 (TF32 off) and bf16, ViT-g/14
with registers in bf16, random weights.

For each: the capture's call (ms, synchronised), a call's median with a
synchronise after each (what the cells' ``dinov2`` span reads, less the
resize and the normalisation), the host's time to issue one call and the
device's time a call over 50 calls back to back (CUDA events), the device
ops of one call (``tools/xmem_key_graph.py::timings``), and whether the
replay's tokens equal the eager call's. Prints one JSON object. Needs a
CUDA card.

    python tools/dinov2_graph.py
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from d3fields_tpu_torch.models import dinov2 as d2  # noqa: E402
from tools.xmem_key_graph import timings  # noqa: E402

GRID = (24, 32)
MODELS = {"vitl14-f32": (d2.Dinov2Config.vit_large, "float32"),
          "vitl14-bf16": (d2.Dinov2Config.vit_large, "bfloat16"),
          "vitg14reg-bf16": (d2.Dinov2Config.vit_giant2_reg, "bfloat16")}


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
    for name, (preset, dtype) in MODELS.items():
        model = d2.init_params(preset(), gen, device=dev)
        bb = d2.Dinov2Backbone(model.eval(), compute_dtype=dtype, device=dev)
        del model
        m, pos = bb.model, bb.interpolated_pos_embed(*GRID)
        xs = [torch.randn(4, GRID[0] * 14, GRID[1] * 14, 3, device=dev, generator=gen)
              for _ in range(4)]
        for _ in range(3):
            m.forward_tokens_eager(xs[0], pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.forward_tokens(xs[0], pos)
        torch.cuda.synchronize()
        row = {"capture_ms": (time.perf_counter() - t0) * 1e3,
               "eager": timings(lambda x: m.forward_tokens_eager(x, pos), xs),
               "graph": timings(lambda x: m.forward_tokens(x, pos), xs),
               "equal": torch.equal(m.forward_tokens(xs[1], pos),
                                    m.forward_tokens_eager(xs[1], pos))}
        out[name] = row
        del bb, m
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
