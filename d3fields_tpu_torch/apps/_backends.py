"""Backends built from checkpoint files, for the apps' recorded-scene path.

Counterpart of ``d3fields_tpu/apps/_backends.py``, with the same
environment variables and errors. Checkpoint sources:

- DINOv2: a torch-hub ``dinov2_vitl14`` state dict (``D3F_DINOV2_CKPT``),
  or another hub backbone (``dinov2_vits14``, ``_vitb14``, ``_vitg14``,
  ``_vitg14_reg``), its preset read from the state dict;
- SAM: a huggingface ``SamModel`` state dict (``D3F_SAM_CKPT``);
- GroundingDINO: a huggingface ``GroundingDinoForObjectDetection`` state
  dict (``D3F_GDINO_CKPT``) and a BERT vocab file (``D3F_BERT_VOCAB``);
- XMem: the reference's ``XMem.pth`` (``D3F_XMEM_CKPT``) for video mask
  propagation (without it, the tracking app re-detects every frame);
- f-BRS and S2M, the interactive tools' click and scribble models: the
  reference's ``fbrs.pth`` (an HRNet-OCR ``DistMapsHRNetModel``, its
  widths read from the state dict) and ``s2m.pth`` (``D3F_FBRS_CKPT``,
  ``D3F_S2M_CKPT``, read by ``apps/interactive.py``).

A torch file loads with ``torch.load`` into the port's modules, which keep
the checkpoints' parameter names, after :func:`audit_state_dict` has
dropped the keys the JAX audit allows unused. A ``.npz`` that the JAX
package wrote (``save_params``) loads through each family's
``load_jax_params``. The SAM encoder (vit-b/l/h) and the Swin trunk
(swin-t/b) are read from the checkpoint's patch-embed weight.

Compute dtypes, as in the JAX package: DINOv2 is built in bfloat16 (its
tokens come back f32); ``D3F_SAM_DTYPE`` and ``D3F_GDINO_DTYPE`` pick
SAM's ViT trunk and GroundingDINO's gated trunk dtype, ``float32`` (the
default) or ``bfloat16``; any other value raises a ValueError naming the
variable. XMem takes ``XMemConfig.compute_dtype`` (float32 here).
``D3F_GDINO_VIEW_CHUNK``, ``D3F_GDINO_QUERY_CHUNK`` and
``D3F_GDINO_GATHER`` are TPU workarounds the port has no use for. Every
backend is built on ``device`` (CUDA unless the caller names another).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from d3fields_tpu_torch.utils.convert import audit_state_dict, load_params
from d3fields_tpu_torch.utils.device import resolve_device


def _load_torch_sd(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "model" in sd and "optimizer" in sd:
        sd = sd["model"]  # a training checkpoint (models/xmem/trainer.py)
    return dict(sd)


def _npz_width(params, leaf, family: str, path: str) -> int:
    """The patch-embed width of a ``.npz`` pytree, read from its ``leaf``."""
    try:
        node = params
        for k in leaf:
            node = node[k]
        return int(node.shape[-1])
    except (KeyError, TypeError, AttributeError):
        raise ValueError(
            f"cannot sniff the {family} model variant from {path!r}: no "
            f"{'/'.join(leaf)} leaf in the pytree — pass an explicit cfg") from None


def _checkpoint_width(sd: dict, key: str, what: str) -> int:
    if key not in sd:
        raise ValueError(f"cannot sniff the {what}: key {key!r} missing from the state "
                         "dict — pass an explicit cfg")
    return int(np.shape(sd[key])[0])


def _env_dtype(var: str) -> str:
    """The compute dtype an environment variable names (default float32)."""
    dtype = os.environ.get(var, "float32")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"{var}={dtype!r}: expected 'float32' or 'bfloat16'")
    return dtype


def load_dinov2(path: str, device):
    from d3fields_tpu_torch.models import dinov2

    if path.endswith(".npz"):
        model = dinov2.Dinov2(dinov2.Dinov2Config.vit_large(), device=device)
        return dinov2.load_jax_params(model, load_params(path)[0])
    sd = _load_torch_sd(path)
    cfg = dinov2.config_for_state_dict(sd)
    model = dinov2.Dinov2(cfg, device=device)
    sd = audit_state_dict(model, sd, "dinov2_hub")
    model.load_state_dict(dinov2.convert_hub_state_dict(sd, cfg), strict=True)
    return model


def load_sam(path: str, device):
    from d3fields_tpu_torch.models.sam import model as S

    if path.endswith(".npz"):
        params = load_params(path)[0]
        cfg = S.config_for_encoder_width(
            _npz_width(params, ("vision", "patch_w"), "sam", path))
        return S.load_jax_params(S.Sam(cfg, device=device), params)
    sd = _load_torch_sd(path)
    cfg = S.config_for_encoder_width(_checkpoint_width(
        sd, "vision_encoder.patch_embed.projection.weight", "SAM encoder variant"))
    model = S.Sam(cfg, device=device)
    model.load_state_dict(audit_state_dict(model, sd, "sam"), strict=True)
    return model


def load_groundingdino(path: str, device):
    from d3fields_tpu_torch.models.groundingdino import model as G

    if path.endswith(".npz"):
        params = load_params(path)[0]
        cfg = G.config_for_trunk(_npz_width(params, ("swin", "patch_w"), "gdino", path))
        return G.load_jax_params(G.GroundingDino(cfg, device=device), params)
    sd = _load_torch_sd(path)
    cfg = G.config_for_trunk(_checkpoint_width(
        sd, "model.backbone.conv_encoder.model.embeddings.patch_embeddings.projection.weight",
        "GroundingDINO trunk"))
    model = G.GroundingDino(cfg, device=device)
    model.load_state_dict(audit_state_dict(model, sd, "gdino"), strict=True)
    return model


def load_xmem(path: str, cfg, device):
    """An XMem from the reference's ``XMem.pth``, a training checkpoint of
    the port (``trainer.save_checkpoint``), a JAX ``.npz`` or a JAX
    trainer pickle."""
    from d3fields_tpu_torch.models.xmem import network as xnet
    from d3fields_tpu_torch.utils.convert import read_trainer_pickle

    model = xnet.XMem(cfg, device=device)
    if path.endswith(".npz"):
        return xnet.load_jax_params(model, load_params(path)[0]).eval()
    blob = read_trainer_pickle(path)
    if blob is not None:
        return xnet.load_jax_params(model, blob["params"]).eval()
    sd = _load_torch_sd(path)
    w = sd.get("value_encoder.conv1.weight")
    if w is not None and w.shape[1] == 4:
        # a single-object checkpoint: a zero 'others' channel (the JAX
        # converter's pad, d3fields_tpu/models/xmem/network.py:337-342)
        sd["value_encoder.conv1.weight"] = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
    model.load_state_dict(audit_state_dict(model, sd, "xmem"), strict=True)
    return model.eval()


def load_fbrs(path: str, device):
    """An f-BRS click model from the reference's ``fbrs.pth`` (width, OCR
    width and ``small`` read from it, ``model.detect_config``)."""
    from d3fields_tpu_torch.models.fbrs import model as F

    sd = _load_torch_sd(path)
    model = F.FbrsModel(F.detect_config(sd), device=device)
    model.load_state_dict(audit_state_dict(model, sd, "fbrs"), strict=True)
    return model.eval()


def load_s2m(path: str, device):
    """The S2M scribble model from the reference's ``s2m.pth`` or a JAX ``.npz``."""
    from d3fields_tpu_torch.models.s2m import model as S

    model = S.S2M(device=device)
    if path.endswith(".npz"):
        return S.load_jax_params(model, load_params(path)[0]).eval()
    model.load_state_dict(audit_state_dict(model, _load_torch_sd(path), "s2m"), strict=True)
    return model.eval()


def build_feature_backend(ckpt: str | None = None, *, device=None):
    from d3fields_tpu_torch.models.dinov2 import Dinov2Backbone

    ckpt = ckpt or os.environ.get("D3F_DINOV2_CKPT")
    if not ckpt or not os.path.exists(ckpt):
        raise FileNotFoundError(
            "DINOv2 checkpoint not found; set D3F_DINOV2_CKPT to a torch-hub "
            "dinov2_vitl14 state dict (or a converted .npz), or run with "
            "--synthetic"
        )
    dev = resolve_device(device)
    return Dinov2Backbone(load_dinov2(ckpt, dev), compute_dtype="bfloat16", device=dev)


def build_mask_backend(sam_ckpt: str | None = None, gdino_ckpt: str | None = None,
                       vocab: str | None = None, *, device=None):
    from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
    from d3fields_tpu_torch.models.sam.predictor import SamPredictor
    from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend

    sam_ckpt = sam_ckpt or os.environ.get("D3F_SAM_CKPT")
    gdino_ckpt = gdino_ckpt or os.environ.get("D3F_GDINO_CKPT")
    vocab = vocab or os.environ.get("D3F_BERT_VOCAB")
    if not (sam_ckpt and gdino_ckpt and os.path.exists(sam_ckpt)
            and os.path.exists(gdino_ckpt)):
        raise FileNotFoundError(
            "SAM/GroundingDINO checkpoints not found; set D3F_SAM_CKPT and "
            "D3F_GDINO_CKPT (+ D3F_BERT_VOCAB), or run with --synthetic"
        )
    sam_dtype, gdino_dtype = _env_dtype("D3F_SAM_DTYPE"), _env_dtype("D3F_GDINO_DTYPE")
    dev = resolve_device(device)
    tokenize = _wordpiece_tokenizer(vocab) if vocab else _no_tokenizer
    return GroundedSAMBackend(
        GroundingDinoDetector(load_groundingdino(gdino_ckpt, dev), tokenize, device=dev,
                              compute_dtype=gdino_dtype),
        SamPredictor(load_sam(sam_ckpt, dev), device=dev, compute_dtype=sam_dtype),
    )


def _no_tokenizer(text: str):
    raise ValueError("no tokenizer configured; set D3F_BERT_VOCAB to a BERT vocab.txt")


def _is_punctuation(ch: str) -> bool:
    import unicodedata

    cp = ord(ch)
    # BERT treats all non-letter/number ASCII as punctuation
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_tokenize(text: str):
    """HF ``BasicTokenizer(do_lower_case=True)`` semantics: clean control
    chars, space out CJK, whitespace-split, lowercase, strip accents (NFD,
    drop Mn), split each punctuation char into its own token."""
    import unicodedata

    cleaned = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        # HF _is_control treats every category-C char (Cc/Cf/Co/Cs/Cn)
        # except \t\n\r as a control character to strip
        if cp == 0 or cp == 0xFFFD or (cat.startswith("C")
                                       and ch not in "\t\n\r"):
            continue
        if ch in "\t\n\r" or cat == "Zs":
            cleaned.append(" ")
        elif _is_cjk(cp):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(ch)
    out = []
    for tok in "".join(cleaned).split():
        tok = tok.lower()
        tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                      if unicodedata.category(c) != "Mn")
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
    return out


def _wordpiece_tokenizer(vocab_path: str):
    """BERT tokenizer from a vocab.txt: full BasicTokenizer preprocessing
    (punctuation splitting, accent stripping, CJK spacing — what the
    reference gets via HF ``BertTokenizer`` inside GroundingDINO) +
    greedy-longest-match WordPiece. Returns content ids only; the detector
    adds [CLS]/[SEP] itself."""
    with open(vocab_path, encoding="utf-8") as f:
        vocab = {w.rstrip("\n"): i for i, w in enumerate(f)}
    unk = vocab.get("[UNK]", 100)

    def wordpiece(word: str):
        if len(word) > 100:  # HF max_input_chars_per_word
            return [unk]
        start, toks = 0, []
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = ("##" if start > 0 else "") + word[start:end]
                if sub in vocab:
                    cur = vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [unk]
            toks.append(cur)
            start = end
        return toks

    def tokenize(text: str):
        ids = []
        for word in _basic_tokenize(text):
            ids.extend(wordpiece(word))
        return ids

    return tokenize


def build_video_tracker_factory(ckpt: str | None = None, *, device=None):
    """Factory for ``Fusion(video_tracker_factory=...)``: called on the
    first tracked frame with (num_views, num_objects, image_hw) once the
    consensus object count is known. Returns None when no XMem checkpoint
    is configured (callers then re-detect every frame)."""
    ckpt = ckpt or os.environ.get("D3F_XMEM_CKPT")
    if not ckpt or not os.path.exists(ckpt):
        return None
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.seg.video_tracker import VideoMaskTracker

    dev = resolve_device(device)
    cfg = XMemConfig()
    model = load_xmem(ckpt, cfg, dev)

    def factory(num_views, num_objects, image_hw):
        return VideoMaskTracker(model, cfg, num_views, num_objects, image_hw, size=cfg.size,
                                device=dev)

    return factory


def build_real_backends(*, device=None):
    return build_feature_backend(device=device), build_mask_backend(device=device)
