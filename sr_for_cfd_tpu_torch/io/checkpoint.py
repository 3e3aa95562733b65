"""SR model checkpoints: a pure-Python reader and writer of Flax's msgpack
format and the weight map between Flax's parameter tree and the port's
`state_dict`, both ways (counterpart of `sr_for_cfd_tpu/io/checkpoint.py`).

`flax.serialization.to_bytes` writes msgpack maps whose leaves are numpy
arrays packed as ext type 1 (payload: msgpack [shape, dtype name, raw
bytes]), numpy scalars as ext type 3 (the same payload, shape []) and
Python complex numbers as ext type 2 (payload: msgpack [real, imag]).
`read_msgpack` decodes that and `write_msgpack` encodes it with the
standard library and numpy only, so the card's machine loads the shipped
weights and writes new ones without msgpack or flax installed;
`flax.serialization.from_bytes` reads what `save_params` writes.
`save_params` / `load_params` keep the JAX package's signatures (a Flax
variables tree in, a tree restored against a template out).

Solver states go to .npz (`save_solver_state` / `load_solver_fields`):
the padded (nx+2, ny+2) u, v, p and the iteration count, the keys and
layout of the JAX package's snapshots, so either package resumes the
other's.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """Minimal msgpack decoder: nil, bool, ints, floats, str, bin, array,
    map and ext (the subset Flax writes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code: (struct format of the length, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = _Reader(bytes(self.take(n)))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = payload.value()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = payload.value()
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack ext type {code}")


class _Writer:
    """Minimal msgpack encoder for what `_Reader` decodes, choosing the
    smallest encoding of each value as the msgpack package does (Python
    floats as float 64, bytes as bin, dicts in insertion order)."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int, fix_max: int, codes) -> None:
        """The header of a str, bin, array, map or ext of length n: a fix
        byte where fix_max allows, else the shortest sized code."""
        if n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.out += struct.pack(">B" + fmt[1:], code, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def int_(self, x: int) -> None:
        if 0 <= x <= 0x7F or -32 <= x < 0:
            self.out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if x < 1 << (8 * struct.calcsize(fmt)):
                    self.out += bytes([code]) + struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too large for msgpack")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    self.out += bytes([code]) + struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too small for msgpack")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out.append(fixext[n])
        else:
            self.head(n, 0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        self.out += struct.pack(">b", code) + payload

    def value(self, x: Any) -> None:
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self.int_(x)
        elif isinstance(x, float):
            self.out += b"\xcb" + struct.pack(">d", x)
        elif isinstance(x, str):
            b = x.encode("utf-8")
            self.head(len(b), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            self.out += b
        elif isinstance(x, (bytes, bytearray, memoryview)):
            b = bytes(x)
            self.head(len(b), 0, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
            self.out += b
        elif isinstance(x, (list, tuple)):
            self.head(len(x), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
            for v in x:
                self.value(v)
        elif isinstance(x, Mapping):
            self.head(len(x), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
            for k, v in x.items():
                self.value(k)
                self.value(v)
        elif isinstance(x, (np.ndarray, np.generic)):
            arr = np.asarray(x)
            payload = _Writer()
            payload.value([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
            self.ext(_EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR,
                     bytes(payload.out))
        elif isinstance(x, complex):
            payload = _Writer()
            payload.value([x.real, x.imag])
            self.ext(_EXT_COMPLEX, bytes(payload.out))
        else:
            raise TypeError(f"cannot write {type(x).__name__} as msgpack")


def to_msgpack(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as Flax's `to_bytes` does."""
    writer = _Writer()
    writer.value(tree)
    return bytes(writer.out)


def read_msgpack(path: str) -> Dict:
    """Decode a Flax msgpack checkpoint into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return out


def _conv(k: np.ndarray) -> np.ndarray:
    """Flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return k.transpose(3, 2, 0, 1)


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel (kh, kw, in, out), applied unflipped ->
    torch ConvTranspose2d weight (in, out, kh, kw), which torch applies
    flipped: flip spatially, then move the channel axes."""
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def params_from_jax(params: Dict, lr_dim: int, hr_dim: int) -> Dict[str, torch.Tensor]:
    """Map a Flax `SuperResolutionAE` parameter tree ({'params': {...}} or
    its inner dict, as numpy arrays) onto the port's `state_dict` keys.

    Flax flattens NHWC activations as (h, w, c); PyTorch flattens NCHW as
    (c, h, w). The encoder's first Dense and the decoder's Dense therefore
    get their feature axis permuted to match."""
    from ..models.autoencoder import DECODER_SPECS, ENCODER_SPECS

    p = params.get("params", params)
    enc, dec = p["encoder_lr"], p["decoder_hr"]
    sd: Dict[str, np.ndarray] = {}
    for i in range(len(ENCODER_SPECS[lr_dim])):
        layer = enc["conv2d" if i == 0 else f"conv2d_{i}"]
        sd[f"encoder_lr.convs.{i}.weight"] = _conv(layer["kernel"])
        sd[f"encoder_lr.convs.{i}.bias"] = layer["bias"]
    k = enc["dense"]["kernel"]  # (h*w*c, 128), rows in (h, w, c) order
    c = ENCODER_SPECS[lr_dim][-1][0]
    hw = int(round((k.shape[0] // c) ** 0.5))
    k = k.reshape(hw, hw, c, -1).transpose(2, 0, 1, 3).reshape(k.shape[0], -1)
    sd["encoder_lr.dense.weight"] = k.T
    sd["encoder_lr.dense.bias"] = enc["dense"]["bias"]
    sd["encoder_lr.latent_vector.weight"] = enc["latent_vector"]["kernel"].T
    sd["encoder_lr.latent_vector.bias"] = enc["latent_vector"]["bias"]

    (h, w, c), ladder = DECODER_SPECS[hr_dim]
    k = dec["dense"]["kernel"]  # (latent, h*w*c), columns in (h, w, c) order
    k = k.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(k.shape[0], -1)
    sd["decoder_hr.dense.weight"] = k.T
    sd["decoder_hr.dense.bias"] = (
        dec["dense"]["bias"].reshape(h, w, c).transpose(2, 0, 1).reshape(-1))
    for i in range(len(ladder)):
        layer = dec[f"conv_transpose_{i}"]
        sd[f"decoder_hr.deconvs.{i}.weight"] = _conv_transpose(layer["kernel"])
        sd[f"decoder_hr.deconvs.{i}.bias"] = layer["bias"]
    sd["decoder_hr.output_conv.weight"] = _conv(dec["output_conv"]["kernel"])
    sd["decoder_hr.output_conv.bias"] = dec["output_conv"]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def _conv_back(w: np.ndarray) -> np.ndarray:
    """torch Conv2d weight (out, in, kh, kw) -> Flax (kh, kw, in, out)."""
    return w.transpose(2, 3, 1, 0)


def _conv_transpose_back(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (in, out, kh, kw) -> Flax (kh, kw, in,
    out), unflipped (the inverse of `_conv_transpose`)."""
    return w.transpose(2, 3, 0, 1)[::-1, ::-1]


def params_to_jax(state_dict: Mapping[str, torch.Tensor], lr_dim: int,
                  hr_dim: int) -> Dict:
    """The exact inverse of `params_from_jax`: the port's `state_dict` as a
    Flax variables tree {'params': {'encoder_lr': ..., 'decoder_hr': ...}}
    of float32 numpy arrays, in Flax's layer order."""
    from ..models.autoencoder import DECODER_SPECS, ENCODER_SPECS

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    enc: Dict[str, Dict[str, np.ndarray]] = {}
    for i in range(len(ENCODER_SPECS[lr_dim])):
        enc["conv2d" if i == 0 else f"conv2d_{i}"] = {
            "kernel": _conv_back(sd[f"encoder_lr.convs.{i}.weight"]),
            "bias": sd[f"encoder_lr.convs.{i}.bias"]}
    k = sd["encoder_lr.dense.weight"].T  # rows in (c, h, w) order
    c = ENCODER_SPECS[lr_dim][-1][0]
    hw = int(round((k.shape[0] // c) ** 0.5))
    enc["dense"] = {
        "kernel": k.reshape(c, hw, hw, -1).transpose(1, 2, 0, 3).reshape(k.shape[0], -1),
        "bias": sd["encoder_lr.dense.bias"]}
    enc["latent_vector"] = {"kernel": sd["encoder_lr.latent_vector.weight"].T,
                            "bias": sd["encoder_lr.latent_vector.bias"]}

    (h, w, c), ladder = DECODER_SPECS[hr_dim]
    k = sd["decoder_hr.dense.weight"].T  # columns in (c, h, w) order
    dec: Dict[str, Dict[str, np.ndarray]] = {"dense": {
        "kernel": k.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(k.shape[0], -1),
        "bias": sd["decoder_hr.dense.bias"].reshape(c, h, w).transpose(1, 2, 0).reshape(-1)}}
    for i in range(len(ladder)):
        dec[f"conv_transpose_{i}"] = {
            "kernel": _conv_transpose_back(sd[f"decoder_hr.deconvs.{i}.weight"]),
            "bias": sd[f"decoder_hr.deconvs.{i}.bias"]}
    dec["output_conv"] = {"kernel": _conv_back(sd["decoder_hr.output_conv.weight"]),
                          "bias": sd["decoder_hr.output_conv.bias"]}

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict)
                else np.ascontiguousarray(v, dtype=np.float32) for k, v in tree.items()}

    return {"params": {"encoder_lr": f32(enc), "decoder_hr": f32(dec)}}


def save_params(path: str, variables: Mapping) -> None:
    """Write a Flax variables tree (nested dicts of numpy arrays, e.g.
    `params_to_jax(...)`) as Flax's msgpack."""
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_msgpack(variables))


def _restore(template: Any, state: Any, path: str) -> Any:
    """Flax's `from_state_dict` over nested dicts: the state's values in the
    template's structure; the key sets must be equal at every level."""
    if not isinstance(template, Mapping):
        return state
    if not isinstance(state, Mapping) or set(map(str, template)) != set(state):
        have = sorted(state) if isinstance(state, Mapping) else type(state).__name__
        raise ValueError(f"The target dict keys and state dict keys do not match "
                         f"at {path or '/'}: target {sorted(map(str, template))}, "
                         f"state {have}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in template.items()}


def load_params(path: str, template: Mapping) -> Dict:
    """Read a Flax msgpack checkpoint against a template tree (e.g.
    `params_to_jax(module.state_dict(), ...)`)."""
    return _restore(template, read_msgpack(path), "")


def load_sr_model(path: str, lr_dim: int, hr_dim: int, device="cuda"):
    """A `SuperResolutionAE` with the weights of a Flax msgpack checkpoint."""
    from ..models.autoencoder import SuperResolutionAE
    from ..utils.device import resolve_device

    device = resolve_device(device)

    model = SuperResolutionAE(lr_dim, hr_dim)
    model.load_state_dict(params_from_jax(read_msgpack(path), lr_dim, hr_dim))
    return model.to(device).eval()



def _npz_path(path: str) -> str:
    """np.savez silently appends '.npz' but np.load uses the path
    verbatim; normalize so save/load round-trip for any input path."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_solver_state(path: str, state) -> None:
    """Snapshot a solver state (anything with padded u, v, p fields as
    tensors or arrays, and an iteration `count`) to .npz."""
    path = _npz_path(path)
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    np.savez(path, u=_host(state.u), v=_host(state.v), p=_host(state.p),
             count=np.asarray(int(state.count), np.int32))


def load_solver_fields(path: str) -> Dict[str, np.ndarray]:
    """Load a snapshot back as the (ny, nx) interior field dict accepted by
    `CFDSolver.warm_start`."""
    with np.load(_npz_path(path)) as data:
        return {k: data[k][1:-1, 1:-1].T.copy() for k in ("u", "v", "p")}


def load_solver_count(path: str) -> int:
    """The iteration count stored in a snapshot."""
    with np.load(_npz_path(path)) as data:
        return int(data["count"])
