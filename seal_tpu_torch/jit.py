"""JitEvaluator and jit.capture: Evaluator pipelines replayed from CUDA graphs.

The port of seal_tpu/jit.py. seal_tpu hides its host dispatch behind
jax.jit; the port runs eagerly, and an op at n = 16384 is a thousand or so
small kernel launches whose host cost exceeds their device time. Here each
op, or each pipeline handed to `capture`, is captured once per cache key
into a torch.cuda.CUDAGraph and then replayed: one launch from the host.

The cache key plays the part of jax.jit's trace signature. Tensors are the
dynamic inputs; everything else is static, as seal_tpu's pytree aux data
is: for each ciphertext its data shape ([size, L, N] or [B, size, L, N]),
dtype, device, parms_id, NTT form, scale and correction factor; for each
key-switching key its type, parms_id and the identity and shape of each key
tensor; every other argument by value; and the two config flags that
choose a route.

Keys are captured per key object, not copied into static buffers. A graph
reads its key tensors by address, and the key's derived caches (the K3
Shoup quotients, the permuted Galois keys) are built from the key on the
eager warm-up call and read by address too. Copying a second key into the
first key's buffers would leave those caches stale, so the identity of
each key tensor is part of the cache key: a second key of the same shapes
gets a graph of its own, never the first key's. The program keeps the key
objects it was captured with alive (seal_tpu passes keys as dynamic
arguments instead, so one compiled relinearize serves every key).

On a CUDA context the first call under a new cache key
1. runs the op eagerly on a side stream (the warm-up, which also fills
   every table and cache the op reads, and runs the device-reading checks
   that capture skips) and returns that result;
2. records the structure and metadata of the output;
3. copies the inputs into static buffers and captures the op on them into a
   CUDA graph, in one memory pool shared by all graphs of the evaluator
   (the graphs run one at a time on one stream, so they may share it). The
   kernel wrappers count each kernel they record into the graph; those
   counts are the graph's launches, which must equal the warm-up's, and
   are taken back out of `cuda.launches`, since the capture ran nothing.

Every later call copies its inputs into the static buffers, replays the
graph, clones the outputs (the next replay overwrites them), rebuilds the
ciphertexts with the recorded metadata and adds the graph's launches to
`cuda.launches`, so a run still counts every kernel launch. A capture that
fails raises; nothing falls back to eager execution. On a CPU context the
same key and cache path runs the op eagerly on the static buffers in place
of a replay: the plain version, which the tests hold against the Evaluator.

As under jax.jit, the body runs only when captured: a device-reading check
inside it (the transparency check) runs on the warm-up call alone, and a
tensor that a captured function closes over is read by address at every
replay.
"""

from __future__ import annotations

import torch

from seal_tpu_torch import cuda
from seal_tpu_torch.config import config
from seal_tpu_torch.context import SEALContext
from seal_tpu_torch.dtypes import Ciphertext, KSwitchKeys, Plaintext
from seal_tpu_torch.evaluator import Evaluator


def _signature(obj, leaves: list, keep: list):
    """The static part of an argument, with its tensors appended to
    `leaves` and the key objects it holds to `keep`."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, Ciphertext):
        leaves.append(obj.data)
        return ("ct", tuple(obj.data.shape), obj.data.dtype, obj.data.device,
                tuple(obj.parms_id), obj.is_ntt_form, obj.scale, obj.correction_factor)
    if isinstance(obj, KSwitchKeys):
        keep.append(obj)
        return ("keys", type(obj).__name__, tuple(obj.parms_id),
                tuple(None if k is None else (id(k), tuple(k.shape)) for k in obj.keys))
    if type(obj) in (list, tuple):
        return (type(obj).__name__,) + tuple(_signature(o, leaves, keep) for o in obj)
    if isinstance(obj, Plaintext):
        raise TypeError("a captured function takes ciphertexts, tensors, keys and "
                        "hashable values; plaintext ops run eagerly")
    hash(obj)                   # an unhashable argument cannot key the cache
    return ("static", type(obj).__name__, obj)


def _substitute(obj, buffers):
    """obj with each tensor leaf replaced by the next of `buffers`, in
    _signature's order."""
    if isinstance(obj, torch.Tensor):
        return next(buffers)
    if isinstance(obj, Ciphertext):
        out = obj.copy()
        out.data = next(buffers)
        return out
    if type(obj) in (list, tuple):
        return type(obj)(_substitute(o, buffers) for o in obj)
    return obj


def _output_spec(out, leaves: list):
    """The structure and metadata of an output, with its tensors appended
    to `leaves`."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return ("tensor",)
    if isinstance(out, Ciphertext):
        leaves.append(out.data)
        return ("ct", tuple(out.parms_id), out.is_ntt_form, out.scale, out.correction_factor)
    if type(out) in (list, tuple):
        return (type(out),) + tuple(_output_spec(o, leaves) for o in out)
    raise TypeError(f"a captured function returns ciphertexts, tensors, lists and "
                    f"tuples of them, or None; got {type(out).__name__}")


def _rebuild(spec, tensors):
    if spec is None:
        return None
    if spec[0] == "tensor":
        return next(tensors)
    if spec[0] == "ct":
        return Ciphertext(next(tensors), *spec[1:])
    return spec[0](_rebuild(s, tensors) for s in spec[1:])


def _tensors_in(obj, found: list) -> list:
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        found.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors_in(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors_in(v, found)
    return found


class _Program:
    """One cache entry: static input buffers, the recorded output spec, and
    the CUDA graph with the launches it holds (None and {} on the CPU)."""

    def __init__(self, fn, args, leaves: list, keep: list, spec):
        self.fn = fn
        self.spec = spec
        self.launches: dict = {}
        self.inputs = [x.clone() for x in leaves]
        self.args = _substitute(args, iter(self.inputs))
        # the key objects and every tensor they hold now (the keys and the
        # caches an Evaluator derived from them) stay alive as long as a
        # graph may read them, and no other tensor takes a key's identity
        self.keep = keep + _tensors_in([k.__dict__ for k in keep], [])
        self.graph = None
        self.outputs: list = []

    @staticmethod
    def build(fn, args, leaves: list, keep: list, pool):
        """(the program, the warm-up call's output): fn run eagerly on args,
        then, on the card, captured on the static buffers."""
        device = leaves[0].device if leaves else torch.device("cpu")
        if device.type != "cuda":
            out = fn(*args)
            return _Program(fn, args, leaves, keep, _output_spec(out, [])), out
        before = dict(cuda.launches)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = fn(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        warm = {k: v - before[k] for k, v in cuda.launches.items()}
        program = _Program(fn, args, leaves, keep, _output_spec(out, []))
        program.graph = torch.cuda.CUDAGraph()
        saved = dict(cuda.launches)
        try:
            with torch.cuda.graph(program.graph, pool=pool()):
                captured = fn(*program.args)
            # the wrappers counted the kernels they recorded into the graph:
            # each replay launches them, the capture launched nothing
            program.launches = {k: v - saved[k] for k, v in cuda.launches.items()}
        finally:
            cuda.launches.update(saved)
        if program.launches != warm:
            raise RuntimeError(f"the graph holds the launches {program.launches}, the "
                               f"eager call made {warm}")
        if _output_spec(captured, program.outputs) != program.spec:
            raise RuntimeError("the captured output differs from the eager one in "
                               "structure or metadata")
        return program, out

    def __call__(self, leaves: list):
        for buf, x in zip(self.inputs, leaves):
            buf.copy_(x)
        if self.graph is None:
            outputs = []
            _output_spec(self.fn(*self.args), outputs)
        else:
            self.graph.replay()
            outputs = self.outputs
            for name, count in self.launches.items():
                cuda.launches[name] += count
        return _rebuild(self.spec, iter([o.clone() for o in outputs]))


class _Cache:
    """Programs by cache key, and the graph memory pool they share: the
    base of JitEvaluator and Captured."""

    def __init__(self):
        self._programs: dict = {}
        self._pool = None

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _call(self, name, fn, args):
        leaves, keep = [], []
        key = (name, config.keyswitch_shoup, config.throw_on_transparent_ciphertext,
               _signature(tuple(args), leaves, keep))
        program = self._programs.get(key)
        if program is not None:
            return program(leaves)
        program, out = _Program.build(fn, args, leaves, keep, self._graph_pool)
        self._programs[key] = program
        return out

    def cache_size(self) -> int:
        return len(self._programs)

    def clear_cache(self):
        self._programs.clear()

    def pool_bytes(self) -> int:
        """Device memory reserved by the shared graph pool (0 before the
        first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class JitEvaluator(_Cache):
    """Evaluator facade whose ops run as cached CUDA graphs.

        jev = JitEvaluator(context)
        ct3 = jev.multiply(ct1, ct2)
        ct3 = jev.relinearize(ct3, relin_keys)

    Every public Evaluator method is reachable. Ops that take a plaintext
    run eagerly, as seal_tpu's do (a BFV/BGV plain op reads the device); an
    `<op>_inplace` twin runs the functional op through the cache and
    rebinds the result onto its first argument."""

    def __init__(self, context: SEALContext):
        super().__init__()
        self.evaluator = Evaluator(context)
        self.context = context

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        method = getattr(self.evaluator, name)
        if not callable(method):
            return method

        def call(*args):
            if name.endswith("_inplace"):
                out = self._dispatch(name[: -len("_inplace")], args)
                if out is not args[0]:
                    args[0].__dict__.clear()
                    args[0].__dict__.update(out.__dict__)
                return args[0]
            return self._dispatch(name, args)

        call.__name__ = name
        return call

    def _dispatch(self, name: str, args):
        method = getattr(self.evaluator, name)
        if any(isinstance(a, Plaintext) for a in args):
            return method(*args)
        return self._call(name, method, args)


def capture(fn) -> "Captured":
    """jax.jit's counterpart for a function of ciphertexts and tensors:

        step = jit.capture(lambda x, y: ev.rescale_to_next(
            ev.relinearize(ev.multiply(x, y), rk)))
        out = step(ct1, ct2)

    The function is captured once per cache key (the shapes and metadata of
    its ciphertext and tensor arguments, its keys, and its other arguments
    by value) and replayed from then on, exactly as a JitEvaluator op is.
    Whatever it closes over is part of the graph, read by address."""
    return Captured(fn)


class Captured(_Cache):
    """A function under `capture`, with its cache of programs."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __call__(self, *args):
        return self._call(None, self.fn, args)
