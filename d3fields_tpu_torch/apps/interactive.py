"""Scriptable interactive video segmentation: the reference's
``XMem/interactive_demo.py`` without the Qt shell.

Counterpart of ``d3fields_tpu/apps/interactive.py``, with the same flags
and command language. The GUI's annotate / commit / propagate loop
(``inference/interact/gui.py``) runs from a command script (``--script``
or stdin) against the workspace layout of the reference's
``ResourceManager`` (``resource_manager.py:39-180``): frames come from
``--video`` or ``--images``, short-side resized into ``<workspace>/images``
(reused when already there, so an interrupted run continues); masks load
from and save to ``<workspace>/masks`` as DAVIS-paletted PNGs.

Commands (one per line; ``#`` starts a comment):

  goto T                     jump to frame T
  object K                   set the click target object (1-based)
  click X Y [+|-]            f-BRS click (default positive)
  scribble OBJ x,y x,y ...   S2M scribble stroke (OBJ 0 = background)
  free OBJ x,y x,y ...       free-paint stroke writing indices
  commit                     adopt the interacted mask for this frame
  propagate [forward|backward] [N]   XMem propagation (N = pause after)
  undo                       undo the last click
  vis MODE PATH              write the viewer overlay (davis|fade|light|
                             popup|layered) to the PNG file PATH
  vis_target K               toggle object K in the popup/layered target set
  import_layer PATH          RGBA layer for 'layered' mode
  reset_mask | clear_memory | import_mask PATH | save

Where the JAX app differs (no OpenCV, Pillow, JPEG encoder or video
decoder here): every workspace frame is written as ``<name>.png``, which
is lossless, where the JAX app re-encodes ``.jpg`` inputs and video frames
as JPEG; ``--images`` reads ``.png``, ``.jpg`` and ``.jpeg`` files and
raises on other image formats (``.bmp``, ...); ``--video`` reads
uncompressed 24-bit AVI (``utils/avi.py``, what ``TrackVis`` writes) and
raises on any other file; ``import_layer`` reads RGB, RGBA, greyscale and
paletted PNGs as ``Image.convert("RGBA")`` does and raises on a
transparency chunk.

Checkpoints: ``D3F_XMEM_CKPT`` / ``D3F_S2M_CKPT`` / ``D3F_FBRS_CKPT`` (or
the ``--*_ckpt`` flags, as in ``interactive_demo.py:31-34``), read by
``apps/_backends.py``; an unset one gives random weights from seeded
generators (f-BRS then at ``FbrsConfig.tiny_test``): the loop runs end to
end, the masks are noise. It runs on CUDA unless ``main`` is given another
``device``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

READ_EXTS = (".png", ".jpg", ".jpeg")
# image formats cv2.imread reads that the port does not
UNREAD_EXTS = (".bmp", ".dib", ".tif", ".tiff", ".webp", ".jp2", ".pbm", ".pgm", ".ppm",
               ".pnm", ".sr", ".ras", ".exr", ".hdr", ".pic")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", default=None,
                   help="folder of input frames (resized into the workspace)")
    p.add_argument("--video", default=None,
                   help="uncompressed 24-bit AVI file (decoded into the workspace)")
    p.add_argument("--workspace", default=None,
                   help="directory for buffered images and output masks "
                        "(default: ./workspace/<input basename>)")
    p.add_argument("--script", default=None, help="command script file (default: read stdin)")
    p.add_argument("--num_objects", type=int, default=1)
    p.add_argument("--size", type=int, default=480,
                   help="short-side resize for processing (-1 = native)")
    p.add_argument("--xmem_ckpt", default=None)
    p.add_argument("--s2m_ckpt", default=None)
    p.add_argument("--fbrs_ckpt", default=None)
    p.add_argument("--key_dim", type=int, default=64)
    p.add_argument("--value_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=64)
    # the GUI's memory knobs (interactive_demo.py:52-62)
    p.add_argument("--mem_every", type=int, default=10)
    p.add_argument("--top_k", type=int, default=30)
    p.add_argument("--max_mid_term_frames", type=int, default=10)
    p.add_argument("--min_mid_term_frames", type=int, default=5)
    p.add_argument("--num_prototypes", type=int, default=128)
    p.add_argument("--max_long_term_elements", type=int, default=10000)
    return p


# ---------------------------------------------------------------------------
# workspace (resource_manager.py:39-180)
# ---------------------------------------------------------------------------

def _short_side_resize(frame: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)`` to a
    short side of ``size``, which may enlarge."""
    from d3fields_tpu_torch.utils.visualization import resize_area_u8

    if size <= 0:
        return frame
    h, w = frame.shape[:2]
    nw, nh = w * size // min(w, h), h * size // min(w, h)
    if (nw, nh) == (w, h):
        return frame
    return resize_area_u8(frame, (nh, nw))


def _read_video(video: str) -> np.ndarray:
    from d3fields_tpu_torch.utils.avi import read_avi

    try:
        return read_avi(video)
    except ValueError as e:
        raise ValueError(f"--video {video!r}: {e}. The port reads uncompressed 24-bit AVI "
                         "(BI_RGB frames, as utils/avi.py writes them) and no other container "
                         "or codec") from e


def prepare_workspace(images, video, workspace, size):
    """Populate ``<workspace>/images`` (reused when already there) and
    return (workspace, frame names, image dir, mask dir)."""
    from d3fields_tpu_torch.utils.png import imread_color, save_png

    if workspace is None:
        if images is not None:
            base = os.path.basename(os.path.normpath(images))
        elif video is not None:
            base = os.path.splitext(os.path.basename(video))[0]
        else:
            raise SystemExit("need --images, --video, or --workspace")
        workspace = os.path.join("./workspace", base)
    image_dir = os.path.join(workspace, "images")
    mask_dir = os.path.join(workspace, "masks")
    have_images = os.path.isdir(image_dir) and os.listdir(image_dir)
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    if not have_images:
        if video is not None:
            for t, frame in enumerate(_read_video(video)):
                save_png(os.path.join(image_dir, f"{t:07d}.png"), _short_side_resize(frame, size))
        elif images is not None:
            for name in sorted(os.listdir(images)):
                stem, ext = os.path.splitext(name)
                if ext.lower() in UNREAD_EXTS:
                    raise ValueError(f"{os.path.join(images, name)}: {ext} frames are not read "
                                     f"here; the port reads {', '.join(READ_EXTS)}")
                if ext.lower() not in READ_EXTS:
                    continue  # not an image (cv2.imread gives None)
                frame = imread_color(os.path.join(images, name))
                save_png(os.path.join(image_dir, stem + ".png"), _short_side_resize(frame, size))
        else:
            raise SystemExit(f"workspace {workspace!r} has no images/ and no --images/--video "
                             "to populate it")
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(image_dir))
    if not names:
        raise SystemExit(f"no frames found in {image_dir}")
    return workspace, names, image_dir, mask_dir


def frame_reader(image_dir: str, names):
    """t -> the workspace frame as RGB uint8 (``cv2.imread(p)[..., ::-1]``)."""
    from d3fields_tpu_torch.utils.png import imread_color

    def get_frame(t):
        for ext in (".jpg", ".png", ".jpeg"):
            p = os.path.join(image_dir, names[t] + ext)
            if os.path.exists(p):
                return np.ascontiguousarray(imread_color(p)[..., ::-1])
        if os.path.exists(os.path.join(image_dir, names[t] + ".bmp")):
            raise ValueError(f"{image_dir}/{names[t]}.bmp: .bmp frames are not read here; "
                             f"the port reads {', '.join(READ_EXTS)}")
        raise FileNotFoundError(names[t])

    return get_frame


# ---------------------------------------------------------------------------
# models (interactive_demo.py:64-88; seeded random weights without checkpoints)
# ---------------------------------------------------------------------------

def _load_models(args, cfg, device):
    import torch

    from d3fields_tpu_torch.apps import _backends
    from d3fields_tpu_torch.apps.click_track import _resolve_ckpt
    from d3fields_tpu_torch.models.fbrs import model as fmod
    from d3fields_tpu_torch.models.fbrs.predictor import FBRSController
    from d3fields_tpu_torch.models.s2m import S2MController
    from d3fields_tpu_torch.models.s2m import model as smod
    from d3fields_tpu_torch.models.xmem import network as xnet

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    ck = _resolve_ckpt(args.xmem_ckpt, "D3F_XMEM_CKPT", "XMem")
    if ck:
        xmodel = _backends.load_xmem(ck, cfg, device)
    else:
        print("[interactive] no XMem checkpoint: random weights (smoke)")
        xmodel = xnet.init_params(cfg, gen(0), device=device)

    ck = _resolve_ckpt(args.s2m_ckpt, "D3F_S2M_CKPT", "S2M")
    if ck:
        smodel = _backends.load_s2m(ck, device)
    else:
        print("[interactive] no S2M checkpoint: random weights (smoke)")
        smodel = smod.init_params(smod.S2mConfig(), gen(1), device=device)
    s2m = S2MController(smodel, num_objects=args.num_objects, device=device)

    ck = _resolve_ckpt(args.fbrs_ckpt, "D3F_FBRS_CKPT", "f-BRS")
    if ck:
        fmodel = _backends.load_fbrs(ck, device)
    else:
        print("[interactive] no f-BRS checkpoint: random weights (smoke)")
        # random weights are noise either way: the tiny config keeps smoke runs cheap
        fmodel = fmod.init_params(fmod.FbrsConfig.tiny_test(), gen(2), device=device)
    fbrs = FBRSController(fmodel, device=device)
    return xmodel, s2m, fbrs


# ---------------------------------------------------------------------------
# command interpreter
# ---------------------------------------------------------------------------

def _parse_points(tokens):
    pts = []
    for tok in tokens:
        x, y = tok.split(",")
        pts.append((float(x), float(y)))
    return pts


def run_command(session, line: str, mask_dir: str, names) -> None:
    from d3fields_tpu_torch.interact import ClickInteraction
    from d3fields_tpu_torch.utils.png import imread_rgba, read_png, save_png

    toks = line.split()
    cmd = toks[0]
    if cmd == "goto":
        session.goto(int(toks[1]))
    elif cmd == "object":
        session.set_object(int(toks[1]))
    elif cmd == "click":
        positive = True if len(toks) < 4 else toks[3] != "-"
        session.click(float(toks[1]), float(toks[2]), positive)
    elif cmd == "scribble":
        session.scribble(_parse_points(toks[2:]), obj=int(toks[1]))
    elif cmd == "free":
        session.free_draw(_parse_points(toks[2:]), obj=int(toks[1]))
    elif cmd == "undo":
        if (session.fbrs_controller is not None
                and isinstance(session.interaction, ClickInteraction)):
            mask = session.fbrs_controller.undo()
            if mask is not None:
                session.interaction.obj_mask = mask
                session._finish_gesture()
    elif cmd == "commit":
        session.commit()
    elif cmd == "propagate":
        forward = True if len(toks) < 2 else toks[1] != "backward"
        cap = int(toks[2]) if len(toks) > 2 else None
        written = session.propagate(forward=forward, max_frames=cap)
        print(f"[interactive] propagated {len(written)} frame(s) "
              f"{'forward' if forward else 'backward'} "
              f"from frame {written[0] - (1 if forward else -1)}"
              if written else "[interactive] nothing to propagate")
    elif cmd == "reset_mask":
        session.reset_mask()
    elif cmd == "clear_memory":
        session.clear_memory()
    elif cmd == "import_mask":
        session.import_mask(read_png(toks[1]))
    elif cmd == "import_layer":
        session.set_layer(imread_rgba(toks[1]))
    elif cmd == "vis_target":
        session.toggle_vis_target(int(toks[1]))
    elif cmd == "vis":
        mode, out_path = toks[1], toks[2]
        if not out_path.lower().endswith(".png"):
            raise ValueError(f"vis writes PNG files here, not {out_path!r}")
        save_png(out_path, session.visualize(mode)[..., ::-1])
        print(f"[interactive] wrote {mode} overlay to {out_path}")
    elif cmd == "save":
        paths = session.save_masks(mask_dir, names=[n + ".png" for n in names])
        print(f"[interactive] saved {len(paths)} mask(s) to {mask_dir}")
    else:
        raise SystemExit(f"unknown command: {line!r}")


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    args = build_parser().parse_args(argv)
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.interact import InteractiveSession
    from d3fields_tpu_torch.utils.device import resolve_device
    from d3fields_tpu_torch.utils.png import read_png

    device = resolve_device(device)
    workspace, names, image_dir, mask_dir = prepare_workspace(
        args.images, args.video, args.workspace, args.size)
    print(f"[interactive] workspace: {workspace} ({len(names)} frames)")
    cfg = XMemConfig(
        key_dim=args.key_dim, value_dim=args.value_dim, hidden_dim=args.hidden_dim,
        mem_every=args.mem_every, top_k=args.top_k,
        max_mid_term_frames=args.max_mid_term_frames,
        min_mid_term_frames=args.min_mid_term_frames, num_prototypes=args.num_prototypes,
        max_long_term_elements=args.max_long_term_elements)
    xmodel, s2m, fbrs = _load_models(args, cfg, device)
    session = InteractiveSession(
        frame_reader(image_dir, names), num_objects=args.num_objects, xmem_model=xmodel,
        xmem_cfg=cfg, s2m_controller=s2m, fbrs_controller=fbrs, num_frames=len(names),
        device=device)

    # continue an interrupted run: adopt the masks already in the workspace
    # (resource_manager.py:169-180)
    for t, name in enumerate(names):
        p = os.path.join(mask_dir, name + ".png")
        if os.path.exists(p):
            session.goto(t)
            session.import_mask(read_png(p))
    session.goto(0)

    lines = (open(args.script).read().splitlines() if args.script
             else sys.stdin.read().splitlines())
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if line:
            run_command(session, line, mask_dir, names)

    # the GUI saves on every commit and propagation step; headless, one
    # more save at the end keeps a script without 'save'
    session.save_masks(mask_dir, names=[n + ".png" for n in names])
    print(f"[interactive] done — masks in {mask_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
