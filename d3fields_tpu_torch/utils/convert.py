"""Checkpoint loading utilities: state-dict views, the key audit, and the
JAX package's ``.npz`` parameter files.

Counterpart of ``d3fields_tpu/utils/convert.py``. The port's modules keep
the parameter names of the checkpoints the reference loads (torch-hub
DINOv2, huggingface SAM and GroundingDINO, ``XMem.pth``), so a checkpoint
loads with ``load_state_dict(strict=True)`` once :func:`audit_state_dict`
has dropped the keys the JAX audit allows unused. Conversion bugs are
silent, so every other leftover or missing key raises, listing the keys.
:func:`load_params` reads a pytree that the JAX package's ``save_params``
wrote; each family's ``load_jax_params`` carries it into the module.
:func:`read_trainer_pickle` reads a JAX trainer checkpoint (a pickle of
numpy leaves and optax state) without importing JAX or optax.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

#: family -> regexes of checkpoint keys the JAX converters never read
#: (``d3fields_tpu/utils/convert.py:140-155``):
#: - dinov2 ``mask_token``: iBOT masking token, inference never uses it;
#: - sam ``prompt_encoder.shared_embedding``: tied duplicate of
#:   ``shared_image_embedding``;
#: - gdino ``relative_position_index``: constant Swin index buffer;
#:   ``model.decoder.bbox_embed`` / ``bbox_embed.{i>0}``: huggingface ties
#:   every box head to ``bbox_embed.0``; ``position_ids``: an arange buffer
#:   older transformers serialised;
#: - xmem, s2m and fbrs ``num_batches_tracked``: batch-norm step counters.
ALLOWED_UNUSED = {
    "dinov2_hub": [r"mask_token"],
    "sam": [r"^prompt_encoder\.shared_embedding\."],
    "gdino": [
        r"relative_position_index",
        r"^model\.decoder\.bbox_embed\.",
        r"^bbox_embed\.(?!0\.)",
        r"position_ids",
    ],
    "xmem": [r"num_batches_tracked"],
    "s2m": [r"num_batches_tracked"],
    "fbrs": [r"num_batches_tracked"],
}


class _NpView(Mapping):
    """Lazy view over a state dict: ``np.asarray`` per read, no bulk copy.

    Converters use this instead of copying the whole dict up front so that
    a key-tracking mapping underneath sees the converter's REAL per-key
    reads.
    """

    def __init__(self, sd: Mapping):
        self._sd = sd

    def __getitem__(self, k):
        return np.asarray(self._sd[k])

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def __contains__(self, k):
        return k in self._sd


def np_view(sd: Mapping) -> _NpView:
    """Wrap a (possibly tracked) state dict for per-key numpy reads."""
    return sd if isinstance(sd, _NpView) else _NpView(sd)


def _shapes(sd: Mapping, keys) -> dict:
    return {k: tuple(np.shape(sd[k])) for k in keys[:20]}


def audit_state_dict(model: torch.nn.Module, sd: Mapping, family: str) -> Dict:
    """``sd`` made ready for ``model.load_state_dict(strict=True)``.

    Every key that ``ALLOWED_UNUSED[family]`` covers is dropped, as the JAX
    converters never read it. A dropped key that ``model`` holds is then
    refilled from the module: a tied duplicate from the checkpoint tensor
    it aliases (so a tie always loads its canonical key, ``bbox_embed.0``,
    ``shared_image_embedding``), a constant buffer (``relative_position_index``,
    ``num_batches_tracked``) from the module's own value. Any other key of
    ``sd`` that ``model`` lacks raises ``ValueError``, and any key of
    ``model`` that ``sd`` lacks raises ``KeyError``, each listing the keys.
    """
    allowed = [re.compile(p) for p in ALLOWED_UNUSED[family]]
    covered = lambda k: any(p.search(k) for p in allowed)  # noqa: E731
    own = model.state_dict(keep_vars=True)
    kept = {k: v for k, v in sd.items() if not covered(k)}
    extra = sorted(set(kept) - set(own))
    if extra:
        raise ValueError(
            f"{family} checkpoint holds {len(extra)} tensor(s) the model has no place for and "
            f"the allow-list does not cover: {_shapes(sd, extra)}"
            f"{' ...' if len(extra) > 20 else ''}")
    storage = {own[k].data_ptr(): k for k in kept}
    for k in sorted(set(own) - set(kept)):
        if covered(k):
            src = storage.get(own[k].data_ptr())
            kept[k] = kept[src] if src is not None else own[k].detach()
    missing = sorted(set(own) - set(kept))
    if missing:
        raise KeyError(f"{family} checkpoint lacks {len(missing)} tensor(s) the model needs: "
                       f"{missing[:20]}{' ...' if len(missing) > 20 else ''}")
    return kept


# ---------------------------------------------------------------------------
# the JAX package's .npz parameter files (its save_params)
# ---------------------------------------------------------------------------

_SEP = "/"


def _unflatten(flat: Mapping[str, np.ndarray]):
    root: Dict = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def load_params(path: str):
    """Load a pytree that ``d3fields_tpu.utils.convert.save_params`` wrote;
    returns (params, meta)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = {
        k.split(_SEP, 1)[1]: str(flat.pop(k))
        for k in list(flat)
        if k.startswith(f"__meta__{_SEP}")
    }
    return _unflatten(flat), meta


class Opaque:
    """Stands in for a class of a trainer pickle outside numpy and the
    standard library (the optimizer state's optax types), so that reading
    the pickle imports neither JAX nor optax. ``cls_name`` is the class it
    stands for; ``args`` are what the pickle built it from (a NamedTuple's
    fields) and ``state`` what it set on it."""

    cls_name = ""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _TrainerUnpickler(pickle.Unpickler):
    _SAFE = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._SAFE:
            return super().find_class(module, name)
        return type(name, (Opaque,), {"cls_name": name})


def read_trainer_pickle(path: str) -> Optional[dict]:
    """The dict a JAX trainer's ``save_checkpoint`` pickled (``"it"``,
    ``"params"``, ``"opt_state"``), optax classes as :class:`Opaque`; None
    if ``path`` is no such pickle. A zip file (``torch.save``'s format) is
    told by its magic and not unpickled."""
    try:
        with open(path, "rb") as f:
            if f.read(4) == b"PK\x03\x04":
                return None
            f.seek(0)
            blob = _TrainerUnpickler(f).load()
    except (pickle.UnpicklingError, EOFError, ValueError):
        return None
    return blob if isinstance(blob, dict) and "params" in blob else None


def find_opaque(tree, cls_name: str):
    """The first :class:`Opaque` standing for ``cls_name`` in a nest of
    tuples, lists and dicts, or None."""
    if isinstance(tree, Opaque):
        if tree.cls_name == cls_name:
            return tree
        tree = tree.args
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            hit = find_opaque(t, cls_name)
            if hit is not None:
                return hit
    return None
