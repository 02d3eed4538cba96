"""Model-spec serialization — a copy of `shifu_tpu/models/spec.py`.

An .npz holding the parameter arrays plus a JSON header (kind, meta,
format version). Both packages read and write the same files, so a
model trained by the JAX package loads here unchanged and the other way
round. numpy-only. `spec_to_bundle` / `bundle_to_spec` are `shifu
convert`'s open zip bundle (meta.json + one .npy a parameter array).
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from shifu_tpu_torch.fileio import atomic_path

FORMAT_VERSION = 1


def _flatten(params: Any, prefix: str = "p") -> Dict[str, np.ndarray]:
    """Flatten a nested list/dict of arrays into npz-friendly keys like
    'p.0.w'."""
    out = {}
    if isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(_flatten(v, f"{prefix}.{i}"))
    elif isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}.{k}"))
    else:
        out[prefix] = np.asarray(params)
    return out


def _unflatten(flat: Dict[str, np.ndarray], prefix: str = "p") -> Any:
    """Inverse of _flatten."""
    children: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        if key == prefix:
            return v
        rest = key[len(prefix) + 1:]
        head = rest.split(".")[0]
        children.setdefault(head, {})[key] = v
    if not children:
        return None
    if all(k.isdigit() for k in children):
        return [_unflatten(children[str(i)], f"{prefix}.{i}")
                for i in range(len(children))]
    return {k: _unflatten(children[k], f"{prefix}.{k}") for k in children}


def save_model(path: str, kind: str, meta: Dict[str, Any],
               params: Any) -> None:
    """Write a model spec: npz of arrays + embedded JSON header, staged
    through a temp name and an atomic rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params)
    header = json.dumps({"format": FORMAT_VERSION, "kind": kind,
                         "meta": meta})
    with atomic_path(path) as tmp:
        np.savez_compressed(tmp if path.endswith(".npz") else tmp + ".npz",
                            __header__=np.frombuffer(header.encode(),
                                                     np.uint8),
                            **flat)
        if not path.endswith(".npz"):
            os.replace(tmp + ".npz", tmp)


def load_model(path: str) -> Tuple[str, Dict[str, Any], Any]:
    """Read a model spec → (kind, meta, params). numpy-only.

    A directory holding `saved_model.pb` loads as an external
    TensorFlow SavedModel (kind "tf", deserialized at scoring time by
    `eval/scorer.py`) — the `core/GenericModel.java` analog: foreign TF
    models, `export -t tf` output included, score inside the ensemble
    beside native specs."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "saved_model.pb")):
            return "tf", {"path": path}, None
        raise ValueError(
            f"{path} is a directory but not a TF SavedModel "
            "(no saved_model.pb)")
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"].tolist()).decode())
        flat = {k: z[k] for k in z.files if k != "__header__"}
    if header.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported model format {header.get('format')}")
    return header["kind"], header["meta"], _unflatten(flat)


def list_models(models_dir: str) -> List[str]:
    """All model specs in a models/ dir, sorted numerically by bag
    index (model10 follows model9)."""
    if not os.path.isdir(models_dir):
        return []

    def bag_index(name: str):
        digits = "".join(c for c in name.split(".")[0] if c.isdigit())
        return (int(digits) if digits else -1, name)

    return [os.path.join(models_dir, f)
            for f in sorted(os.listdir(models_dir), key=bag_index)
            if f.startswith("model") and not f.endswith(".json")]


def spec_to_bundle(spec_path: str, out_zip: str) -> str:
    """`shifu convert` (`util/IndependentTreeModelUtils.java`): repackage
    a compact .npz spec as an open zip bundle — meta.json + one raw
    little-endian .npy per parameter array — readable by any runtime
    without numpy's npz container."""
    import zipfile
    kind, meta, params = load_model(spec_path)
    flat = _flatten(params)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(
            {"format": FORMAT_VERSION, "kind": kind, "meta": meta,
             "arrays": sorted(flat)}, indent=1))
        for key in sorted(flat):
            buf = io.BytesIO()
            np.save(buf, np.asarray(flat[key]))
            zf.writestr(f"arrays/{key}.npy", buf.getvalue())
    return out_zip


def bundle_to_spec(zip_path: str, out_spec: str) -> str:
    """Inverse of spec_to_bundle: zip bundle → compact .npz spec."""
    import zipfile
    with zipfile.ZipFile(zip_path) as zf:
        header = json.loads(zf.read("meta.json").decode())
        flat = {}
        for key in header["arrays"]:
            flat[key] = np.load(io.BytesIO(zf.read(f"arrays/{key}.npy")),
                                allow_pickle=False)
    save_model(out_spec, header["kind"], header["meta"], _unflatten(flat))
    return out_spec
