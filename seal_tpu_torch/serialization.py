"""SEAL 4.0's wire format for the port's objects.

The port's own copy of seal_tpu/serialization.py (SEAL
serialization.{h,cpp}): the 16-byte SEALHeader {magic 0xA15E, header size
0x10, version, compression mode, reserved, total size}, nested headers per
member object, and the member layouts of Modulus (modulus.cpp:18),
EncryptionParameters (encryptionparams.cpp:15), Plaintext
(plaintext.cpp:204), Ciphertext with seed compression
(ciphertext.cpp:190-340), the SecretKey and PublicKey wrappers,
KSwitchKeys (kswitchkeys.cpp:42) and UniformRandomGeneratorInfo
(randomgen.cpp:99). Bytes that SEAL or seal_tpu save load here, and the
port's bytes load there.

Compression: none and zlib always; zstd only where the `zstandard` module
imports, else asking for it raises (it never turns into zlib).

A save moves an object's residues off its device once, as the uint64 view
of its int64 tensor; a load moves them onto the context's device once. A
seed-compressed ciphertext or key stores c0 and the (prng type, seed) of
c1, and a load regenerates c1 from the seed with the port's own byte
stream. Every loaded ciphertext and key is checked against the context
(valcheck.py) before it is returned.
"""

from __future__ import annotations

import enum
import io
import struct
import zlib

import numpy as np
import torch

from seal_tpu_torch import randomgen, rlwe, valcheck
from seal_tpu_torch.dtypes import (
    Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, PublicKey, RelinKeys, SecretKey,
    u64_numpy)
from seal_tpu_torch.encryption_params import PARMS_ID_ZERO, EncryptionParameters, SchemeType
from seal_tpu_torch.modulus import Modulus

SEAL_MAGIC = 0xA15E
HEADER_SIZE = 0x10
VERSION_MAJOR = 4
VERSION_MINOR = 0

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None


class ComprMode(enum.IntEnum):
    NONE = 0
    ZLIB = 1
    ZSTD = 2


def _zstd_module():
    if _zstd is None:
        raise ValueError("zstd compression is not available")
    return _zstd


def _compress(data: bytes, mode: ComprMode) -> bytes:
    if mode == ComprMode.NONE:
        return data
    if mode == ComprMode.ZLIB:
        return zlib.compress(data)
    if mode == ComprMode.ZSTD:
        return _zstd_module().ZstdCompressor().compress(data)
    raise ValueError("unsupported compression mode")


def _decompress(data: bytes, mode: ComprMode) -> bytes:
    if mode == ComprMode.NONE:
        return data
    if mode == ComprMode.ZLIB:
        return zlib.decompress(data)
    if mode == ComprMode.ZSTD:
        return _zstd_module().ZstdDecompressor().decompress(data)
    raise ValueError("unsupported compression mode")


def wrap(members: bytes, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    """The member bytes, compressed, behind a SEALHeader."""
    payload = _compress(members, compr_mode)
    return struct.pack("<HBBBBHQ", SEAL_MAGIC, HEADER_SIZE, VERSION_MAJOR, VERSION_MINOR,
                       int(compr_mode), 0, HEADER_SIZE + len(payload)) + payload


def load_header(header: bytes, try_upgrade_if_invalid: bool = True):
    """(major, minor, compression mode, total size) of a 16-byte SEALHeader;
    a SEAL 3.4 header (magic u16, zero u8, compression u8, size u32,
    reserved u64) reads as version (3, 4) when try_upgrade_if_invalid
    (serialization.h:212 LoadHeader)."""
    magic, hsize, vmaj, vmin, compr, _, size = struct.unpack("<HBBBBHQ", header)
    valid = (magic == SEAL_MAGIC and hsize == HEADER_SIZE and vmaj <= VERSION_MAJOR
             and compr in ComprMode._value2member_map_)
    if not valid and try_upgrade_if_invalid:
        l_magic, l_zero, l_compr, l_size, _ = struct.unpack("<HBBIQ", header)
        if l_magic == SEAL_MAGIC and l_zero == 0 and l_compr in ComprMode._value2member_map_:
            return 3, 4, ComprMode(l_compr), l_size
    if magic != SEAL_MAGIC:
        raise ValueError("SEALHeader is invalid (bad magic)")
    if hsize != HEADER_SIZE:
        raise ValueError("SEALHeader is invalid (bad size)")
    if vmaj > VERSION_MAJOR:
        raise ValueError("unsupported SEAL version")
    return vmaj, vmin, ComprMode(compr), size


def unwrap(stream: io.BytesIO) -> bytes:
    """The member bytes of the next SEALHeader-framed object of the stream."""
    header = stream.read(HEADER_SIZE)
    if len(header) != HEADER_SIZE:
        raise ValueError("insufficient data for SEALHeader")
    vmaj, vmin, compr, size = load_header(header)
    if (vmaj, vmin) == (3, 4):
        raise ValueError("legacy SEAL 3.4 payloads use a pre-4.0 member wire format; "
                         "only the header can be recognized")
    return _decompress(stream.read(size - HEADER_SIZE), compr)


def _stream(data) -> io.BytesIO:
    return io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data


# -- DynArray -----------------------------------------------------------------

def _dynarray_bytes(values: np.ndarray) -> bytes:
    return wrap(struct.pack("<Q", values.size) + values.astype("<u8", copy=False).tobytes())


def _load_dynarray(stream: io.BytesIO) -> np.ndarray:
    members = io.BytesIO(unwrap(stream))
    (size,) = struct.unpack("<Q", members.read(8))
    if 8 * size > len(members.getbuffer()) - members.tell():
        raise ValueError("dynarray size exceeds the payload")
    return np.frombuffer(members.read(8 * size), dtype="<u8").astype(np.uint64)


# -- Modulus, EncryptionParameters, PRNG info ---------------------------------

def save_modulus(m: Modulus, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    return wrap(struct.pack("<Q", m.value), compr_mode)


def load_modulus(stream) -> Modulus:
    (value,) = struct.unpack("<Q", unwrap(_stream(stream))[:8])
    return Modulus(value)


def save_encryption_parameters(parms: EncryptionParameters,
                               compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    members = struct.pack("<BQQ", int(parms.scheme), parms.poly_modulus_degree,
                          len(parms.coeff_modulus))
    members += b"".join(save_modulus(m) for m in parms.coeff_modulus)
    members += save_modulus(parms.plain_modulus)
    return wrap(members, compr_mode)


def load_encryption_parameters(data) -> EncryptionParameters:
    members = io.BytesIO(unwrap(_stream(data)))
    scheme, n, count = struct.unpack("<BQQ", members.read(17))
    parms = EncryptionParameters(SchemeType(scheme))
    if n:
        parms.set_poly_modulus_degree(n)
    moduli = [load_modulus(members) for _ in range(count)]
    if moduli:
        parms.set_coeff_modulus(moduli)
    plain = load_modulus(members)
    if plain.value:
        parms.set_plain_modulus(plain)
    return parms


def save_prng_info(info, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    prng_type, seed = info
    return wrap(struct.pack("<B8Q", int(prng_type), *seed), compr_mode)


def load_prng_info(stream):
    members = unwrap(_stream(stream))
    prng_type, *seed = struct.unpack("<B8Q", members[:65])
    return prng_type, tuple(seed)


# -- Plaintext ------------------------------------------------------------------

def save_plaintext(p: Plaintext, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    data = (np.zeros(0, dtype=np.uint64) if p.data is None
            else u64_numpy(p.data).reshape(-1))
    members = struct.pack("<4QQd", *p.parms_id, data.size, p.scale) + _dynarray_bytes(data)
    return wrap(members, compr_mode)


def load_plaintext(context, data) -> Plaintext:
    members = io.BytesIO(unwrap(_stream(data)))
    *parms_id, _, scale = struct.unpack("<4QQd", members.read(48))
    values = _load_dynarray(members)
    parms_id = tuple(parms_id)
    if parms_id == PARMS_ID_ZERO:
        return Plaintext(_to_device(values, context), scale=scale)
    cd = context.get_context_data(parms_id)
    if cd is None:
        raise ValueError("plaintext parms_id is invalid for the context")
    rows = values.reshape(cd.coeff_modulus_size, cd.parms.poly_modulus_degree)
    return Plaintext(_to_device(rows, context), parms_id, scale)


def _to_device(values: np.ndarray, context) -> torch.Tensor:
    """uint64 host words -> an int64 tensor on the context's device, one
    transfer."""
    return torch.from_numpy(np.ascontiguousarray(values).view(np.int64)).to(context.device)


# -- Ciphertext ---------------------------------------------------------------------

_CT_META = "<4QBQQQdQ"


def _ciphertext_bytes(words: np.ndarray, parms_id, is_ntt_form, scale, correction_factor,
                      seed_info) -> bytes:
    """words: uint64 [size, L, N] on the host."""
    size, L, n = words.shape
    members = struct.pack(_CT_META, *parms_id, int(bool(is_ntt_form)), size, n, L,
                          scale, correction_factor)
    if seed_info is not None and size == 2:
        # seed-compressed: c0 and the PRNG info that regenerates c1
        members += _dynarray_bytes(words[0].reshape(-1)) + save_prng_info(seed_info)
    else:
        members += _dynarray_bytes(words.reshape(-1))
    return members


def save_ciphertext(ct: Ciphertext, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    if ct.batch_shape:
        raise ValueError("save_ciphertext takes one ciphertext, not a batch")
    return wrap(_ciphertext_bytes(ct.to_numpy(), ct.parms_id, ct.is_ntt_form, ct.scale,
                                  ct.correction_factor, ct.seed_info), compr_mode)


def _read_ciphertext(context, stream):
    """(host words [size, L, N], metadata, seed info or None) of the next
    serialized ciphertext; a seeded c1 is regenerated on the host."""
    members = io.BytesIO(unwrap(stream))
    meta = struct.unpack(_CT_META, members.read(struct.calcsize(_CT_META)))
    parms_id, (is_ntt, size, n, L, scale, correction) = tuple(meta[:4]), meta[4:]
    cd = context.get_context_data(parms_id)
    if cd is None:
        raise ValueError("ciphertext parms_id is invalid for the context")
    values = _load_dynarray(members)
    seed_info = None
    if values.size == n * L and size == 2:
        seed_info = load_prng_info(members)
        c1 = rlwe.sample_poly_uniform(randomgen.make_prng(*seed_info), cd.key_moduli(), n)
        words = np.stack([values.reshape(L, n), c1])
    else:
        words = values.reshape(size, L, n)
    return words, (parms_id, bool(is_ntt), float(scale), int(correction)), seed_info


def load_ciphertext(context, data, _allow_key_levels: bool = False) -> Ciphertext:
    """A seed-compressed ciphertext keeps its seed info, so that saving it
    again gives the same bytes (seal_tpu drops it and saves c1 whole)."""
    words, (parms_id, is_ntt, scale, correction), seed_info = _read_ciphertext(
        context, _stream(data))
    ct = Ciphertext(_to_device(words, context), parms_id, is_ntt, scale, correction)
    ct.seed_info = seed_info
    _check_loaded(ct, context, _allow_key_levels)
    return ct


def _check_loaded(obj, context, allow_key_levels: bool = False):
    """Refuse a loaded object that is not valid for the context (SEAL's
    load -> is_valid_for, valcheck.cpp:31-162)."""
    if isinstance(obj, Ciphertext) and allow_key_levels:
        ok = valcheck.is_metadata_valid_for(obj, context, allow_pure_key_levels=True)
    else:
        ok = valcheck.is_metadata_valid_for(obj, context)
    if not (ok and valcheck.is_buffer_valid(obj) and valcheck.is_data_valid_for(obj, context)):
        raise ValueError("loaded data is invalid for the encryption parameters")


# -- Keys ------------------------------------------------------------------------------

def save_secret_key(sk: SecretKey, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    return save_plaintext(Plaintext(sk.data, tuple(sk.parms_id)), compr_mode)


def load_secret_key(context, data) -> SecretKey:
    p = load_plaintext(context, data)
    sk = SecretKey(p.data, tuple(p.parms_id))
    _check_loaded(sk, context)
    return sk


def save_public_key(pk: PublicKey, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    return save_ciphertext(pk.data, compr_mode)


def load_public_key(context, data) -> PublicKey:
    pk = PublicKey(load_ciphertext(context, data, _allow_key_levels=True))
    _check_loaded(pk, context)
    return pk


def save_kswitch_keys(keys: KSwitchKeys, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
    """Each key [d, 2, L_key, N] as d key-level NTT-form ciphertexts; a key
    made with save_seed stores each digit seed-compressed. Every key leaves
    the device in one transfer."""
    present = [k for k in keys.keys if k is not None]
    host = (u64_numpy(torch.cat([k.reshape(-1) for k in present])) if present
            else np.zeros(0, dtype=np.uint64))
    out = [struct.pack("<4QQ", *keys.parms_id, len(keys.keys))]
    offset = 0
    for index, k in enumerate(keys.keys):
        if k is None:
            out.append(struct.pack("<Q", 0))
            continue
        words = host[offset:offset + k.numel()].reshape(tuple(k.shape))
        offset += k.numel()
        seeds = keys.seeds[index] if keys.seeds is not None else None
        out.append(struct.pack("<Q", words.shape[0]))
        for i in range(words.shape[0]):
            out.append(wrap(_ciphertext_bytes(
                words[i], keys.parms_id, True, 1.0, 1,
                None if seeds is None else seeds[i])))
    return wrap(b"".join(out), compr_mode)


def _load_kswitch_into(keys: KSwitchKeys, context, data) -> KSwitchKeys:
    members = io.BytesIO(unwrap(_stream(data)))
    *parms_id, count = struct.unpack("<4QQ", members.read(40))
    host, seeds = [], []
    for _ in range(count):
        (digits,) = struct.unpack("<Q", members.read(8))
        read = [_read_ciphertext(context, members) for _ in range(digits)]
        host.append(np.stack([r[0] for r in read]) if digits else None)
        seeds.append([r[2] for r in read] if digits and read[0][2] is not None else None)
    present = [h for h in host if h is not None]
    flat = (_to_device(np.concatenate([h.reshape(-1) for h in present]), context)
            if present else None)
    keys.keys, offset = [], 0
    for h in host:
        if h is None:
            keys.keys.append(None)
            continue
        keys.keys.append(flat[offset:offset + h.size].view(h.shape))
        offset += h.size
    keys.parms_id = tuple(parms_id)
    # seeds kept, as load_ciphertext keeps them, when the keys were seeded
    keys.seeds = seeds if any(s is not None for s in seeds) else None
    _check_loaded(keys, context)
    return keys


def load_kswitch_keys(context, data) -> KSwitchKeys:
    return _load_kswitch_into(KSwitchKeys(), context, data)


def load_relin_keys(context, data) -> RelinKeys:
    return _load_kswitch_into(RelinKeys(), context, data)


def load_galois_keys(context, data) -> GaloisKeys:
    return _load_kswitch_into(GaloisKeys(), context, data)


save_relin_keys = save_kswitch_keys
save_galois_keys = save_kswitch_keys


# -- the instance methods: obj.save() -> bytes, obj.load(context, data) ---------------
#
# SEAL's objects each have save/load (serialization.h's wrappers); seal_tpu
# attaches them to its classes, and so does the port. load rebinds the loaded
# state onto the receiver and returns it. The package's __init__ imports this
# module, so the methods are always there.

def _attach_io(cls, save_fn, load_fn, needs_context: bool = True):
    def save(self, compr_mode: ComprMode = ComprMode.NONE) -> bytes:
        return save_fn(self, compr_mode)

    def load(self, *args):
        out = load_fn(*args) if needs_context else load_fn(args[-1])
        self.__dict__.clear()
        self.__dict__.update(out.__dict__)
        return self

    save.__doc__ = f"{save_fn.__name__}(self, compr_mode) -> bytes."
    load.__doc__ = f"{load_fn.__name__}(...), its state rebound onto self; returns self."
    cls.save, cls.load = save, load


_attach_io(Plaintext, save_plaintext, load_plaintext)
_attach_io(Ciphertext, save_ciphertext, load_ciphertext)
_attach_io(SecretKey, save_secret_key, load_secret_key)
_attach_io(PublicKey, save_public_key, load_public_key)
_attach_io(KSwitchKeys, save_kswitch_keys, load_kswitch_keys)
_attach_io(RelinKeys, save_relin_keys, load_relin_keys)
_attach_io(GaloisKeys, save_galois_keys, load_galois_keys)
_attach_io(EncryptionParameters, save_encryption_parameters, load_encryption_parameters,
           needs_context=False)
# Modulus is a frozen value type: save() only (load_modulus() makes one)
Modulus.save = lambda self, compr_mode=ComprMode.NONE: save_modulus(self, compr_mode)
