"""The ctypes bindings of the port's CUDA kernels against their C sources.

``pathway_tpu_torch/ops/_cuda.py`` declares, for every ``extern "C"``
function of ``csrc/*.cu``, the ctypes ``argtypes`` it is called with.
Nothing on the CPU compiles or calls those functions, so a binding that
drifts from its prototype (a parameter added on one side only, or a
pointer declared ``c_int``, which ctypes cuts to 32 bits) would show only
on the card.  Here each prototype is parsed from its source and held
against its binding: the same number of parameters, a ``c_void_p`` for
every pointer, and the matching ctypes type for every scalar.  The
wrappers are then run on CPU tensors up to their launch, which is
recorded: each passes its tensors' device and one Python value of the
bound kind per parameter (the stream aside), and the KNN wrapper picks
the GEMV below 16 queries and the GEMM from 16.  ``_cuda.launch``
itself runs over a stub library: it launches on the stream of the
device it is given, with that device current; the wrappers refuse
operands on two devices before any launch.
"""

import ctypes
import re

import pytest
import torch

from pathway_tpu_torch.ops import _cuda

_PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}

BINDINGS = [(src, fn) for src, fns in sorted(_cuda.SOURCES.items())
            for fn in sorted(fns)]


def _prototypes(source: str) -> dict[str, list[str]]:
    """{function: [parameter declarations]} of a source's C interface."""
    text = re.sub(r"//[^\n]*", "", (_cuda.CSRC / source).read_text())
    return {name: [p.strip() for p in params.split(",") if p.strip()]
            for name, params in _PROTO.findall(text)}


def _ctype(decl: str):
    """The ctypes type a C parameter declaration is passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const ", "").split()
    return _SCALARS[" ".join(words[:-1])]


@pytest.mark.parametrize("source,fn", BINDINGS, ids=lambda x: str(x))
def test_binding_matches_the_c_prototype(source, fn):
    protos = _prototypes(source)
    assert fn in protos, f"{fn} is bound but not exported by {source}"
    params = protos[fn]
    argtypes = _cuda.SOURCES[source][fn]
    assert len(argtypes) == len(params), (
        f"{fn}: {len(argtypes)} argtypes for {len(params)} C parameters")
    for i, (decl, bound) in enumerate(zip(params, argtypes)):
        assert bound is _ctype(decl), (
            f"{fn} parameter {i} ({decl!r}) bound as {bound.__name__}")
    # _cuda.launch appends PyTorch's current stream
    assert params[-1].endswith("* stream")


@pytest.mark.parametrize("source", sorted(_cuda.SOURCES))
def test_every_exported_function_is_bound(source):
    assert set(_prototypes(source)) == set(_cuda.SOURCES[source])


def test_every_kernel_source_is_registered():
    on_disk = {p.name for p in _cuda.CSRC.glob("*.cu")}
    assert on_disk == set(_cuda.SOURCES)


def test_prototype_parser_reads_pointers_and_scalars():
    assert _ctype("const void* q") is ctypes.c_void_p
    assert _ctype("void* stream") is ctypes.c_void_p
    assert _ctype("long long q_sb") is ctypes.c_longlong
    assert _ctype("int causal") is ctypes.c_int
    assert _ctype("float scale") is ctypes.c_float
    with pytest.raises(KeyError):
        _ctype("double x")


# -- the Python call sites ---------------------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """Run the kernel wrappers on CPU tensors up to their launch: the
    device check is lifted (the others stay) and ``_cuda.launch`` records
    its arguments instead of calling the library."""
    from pathway_tpu_torch.ops import attention_cuda

    check = _cuda.check

    def check_any_device(t, name, *, device=None, **kw):
        assert t.device.type == "cpu" and device in (None, t.device)
        check(_OnCuda(t), name, **kw)

    calls = []
    monkeypatch.setattr(_cuda, "check", check_any_device)
    monkeypatch.setattr(attention_cuda, "_check_operand", lambda *a: None)
    # the paged wrappers key their scratch by the launch's stream
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream(0))
    def launch(source, fn, name, device, *args):
        assert device == torch.device("cpu")  # the tensors' own device
        calls.append((source, fn, name, args))

    monkeypatch.setattr(_cuda, "launch", launch)
    return calls


class _FakeStream:
    def __init__(self, handle):
        self.cuda_stream = handle


class _OnCuda:
    """A CPU tensor that reports a CUDA device to ``_cuda.check``."""

    def __init__(self, t, device="cuda"):
        self._t = t
        self.device = torch.device(device)

    def __getattr__(self, attr):
        return getattr(self._t, attr)


def _assert_call_matches_binding(call):
    source, fn, _name, args = call
    argtypes = _cuda.SOURCES[source][fn]
    # the stream is appended by _cuda.launch itself
    assert len(args) == len(argtypes) - 1, f"{fn}: {len(args)} arguments"
    for i, (arg, bound) in enumerate(zip(args, argtypes)):
        want = float if bound is ctypes.c_float else int
        assert type(arg) is want, f"{fn} argument {i}: {type(arg).__name__}"


@pytest.mark.parametrize("Q,fn", [(1, "pw_knn_scores_gemv"),
                                  (15, "pw_knn_scores_gemv"),
                                  (16, "pw_knn_scores_gemm"),
                                  (64, "pw_knn_scores_gemm")])
def test_knn_wrapper_picks_its_variant_by_query_count(recorded_launches, Q,
                                                      fn):
    from pathway_tpu_torch.ops.knn_cuda import knn_scores_cuda

    out = knn_scores_cuda(torch.zeros((Q, 37)), torch.zeros((300, 37)))
    assert tuple(out.shape) == (Q, 300)
    [call] = recorded_launches
    assert call[1] == fn and call[2] == "knn_scores"
    _assert_call_matches_binding(call)
    assert call[3][3:] == (Q, 300, 37)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_passes_every_bound_argument(recorded_launches, dtype):
    from pathway_tpu_torch.ops.attention_cuda import flash_attention_cuda

    qkv = torch.zeros((2, 65, 3 * 4 * 32), dtype=dtype)
    q, k, v = (t.reshape(2, 65, 4, 32) for t in qkv.chunk(3, -1))
    flash_attention_cuda(q, k, v, causal=True)
    [call] = recorded_launches
    _assert_call_matches_binding(call)
    args = call[3]
    # B, T, H, hd, then the (batch, token, head) strides of the views
    assert args[4:8] == (2, 65, 4, 32)
    assert args[8:11] == (65 * 384, 384, 32)


def test_paged_wrappers_pass_every_bound_argument(recorded_launches):
    from pathway_tpu_torch.kvcache import paged_attention as pa

    B, C, H, hd, NB, BS = 2, 3, 2, 32, 6, 4
    q = torch.zeros((B, C, H, hd))
    pool = torch.zeros((NB, BS, H, hd))
    bt = torch.zeros((B, 2), dtype=torch.int32)
    ctx = torch.full((B,), 4, dtype=torch.int32)
    pa.paged_attention_cuda(q, pool, pool.clone(), bt, ctx, ctx)
    new = torch.zeros((B, H, hd))
    pa.paged_append_attend_cuda(torch.zeros((B, 1, H, hd)), new, new.clone(),
                                pool, pool.clone(), bt, ctx, ctx, ctx)
    assert [c[1] for c in recorded_launches] == ["pw_paged_attention",
                                                 "pw_paged_append_attend"]
    for call in recorded_launches:
        _assert_call_matches_binding(call)


def test_paged_wrappers_split_the_table_span(recorded_launches):
    """The split length and count the wrappers pass (and size the scratch
    for): one split per ``RAGGED_SPLIT`` / ``APPEND_SPLIT`` tokens of the
    table's span, which the host knows without reading the contexts."""
    from pathway_tpu_torch.kvcache import paged_attention as pa

    B, C, H, hd, BS, NBT = 2, 32, 2, 64, 16, 40  # tables span 640 tokens
    pool = torch.zeros((B * NBT + 1, BS, H, hd), dtype=torch.bfloat16)
    bt = torch.zeros((B, NBT), dtype=torch.int32)
    ctx = torch.full((B,), 640, dtype=torch.int32)
    bf16 = dict(dtype=torch.bfloat16)
    pa.paged_attention_cuda(torch.zeros((B, C, H, hd), **bf16), pool,
                            pool.clone(), bt, ctx, ctx)
    new = torch.zeros((B, H, hd), **bf16)
    pa.paged_append_attend_cuda(torch.zeros((B, 1, H, hd), **bf16), new,
                                new.clone(), pool, pool.clone(), bt, ctx,
                                ctx, ctx)
    ragged, append = (call[3] for call in recorded_launches)
    # ... B, C, H, hd, BS, NBT, split, n_split, dtype, scale
    assert ragged[9:18] == (B, C, H, hd, BS, NBT, pa.RAGGED_SPLIT, 3, 1)
    # ... B, H, hd, BS, NBT, split, n_split, dtype, scale
    assert append[12:20] == (B, H, hd, BS, NBT, pa.APPEND_SPLIT, 5, 1)


def test_the_paged_scratch_is_per_stream(recorded_launches, monkeypatch):
    """Each wrapper's split partials and arrival counters are keyed by the
    stream the launch goes to: two streams launching one shape (or a
    graph capture on a side stream beside eager launches) get distinct
    buffers, and launches on one stream reuse theirs."""
    from pathway_tpu_torch.kvcache import paged_attention as pa

    monkeypatch.setattr(pa, "_SCRATCH", {})
    stream = [_FakeStream(7)]
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream[0])
    B, C, H, hd, NB, BS = 2, 3, 2, 32, 6, 4
    q = torch.zeros((B, C, H, hd))
    pool = torch.zeros((NB, BS, H, hd))
    bt = torch.zeros((B, 2), dtype=torch.int32)
    ctx = torch.full((B,), 4, dtype=torch.int32)
    new = torch.zeros((B, H, hd))

    def launch_both():
        pa.paged_attention_cuda(q, pool, pool.clone(), bt, ctx, ctx)
        pa.paged_append_attend_cuda(torch.zeros((B, 1, H, hd)), new,
                                    new.clone(), pool, pool.clone(), bt,
                                    ctx, ctx, ctx)

    def scratch_args(calls):
        """(partials, counters) pointers each launch was passed."""
        ptrs = {t.data_ptr() for pair in pa._SCRATCH.values() for t in pair}
        return [tuple(a for a in call[3] if type(a) is int and a in ptrs)
                for call in calls]

    for handle in (7, 8, 7):
        stream[0] = _FakeStream(handle)
        launch_both()
    first, second, again = (scratch_args(recorded_launches[i:i + 2])
                            for i in (0, 2, 4))
    assert all(len(pair) == 2 for pair in first + second)
    for a, b in zip(first, second):  # per kernel: stream 7 against 8
        assert not set(a) & set(b)
    assert again == first  # stream 7 again: the same buffers
    assert len(pa._SCRATCH) == 4  # two shapes on two streams
    assert {key[1] for key in pa._SCRATCH} == {7, 8}


# -- the launch itself, over a stub library ----------------------------------


@pytest.fixture
def stub_cuda(monkeypatch):
    """``_cuda.lib`` returns a stub whose functions record their
    arguments, the current device and return 0; the streams and the
    device context are PyTorch's API surface, faked per device."""
    calls = []
    current = ["cuda:0"]
    switches = []

    class _Stream:
        def __init__(self, device):
            self.cuda_stream = 1000 + torch.device(device).index

    class _DeviceCtx:
        def __init__(self, device):
            self.device = str(device)

        def __enter__(self):
            switches.append(self.device)
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class _Lib:
        def __getattr__(self, fn):
            def call(*args):
                calls.append((fn, args, current[0]))
                return 0
            return call

    monkeypatch.setattr(_cuda, "lib", lambda source: _Lib())
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: torch.device(current[0]).index)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(device or current[0]))
    monkeypatch.setattr(torch.cuda, "device", _DeviceCtx)
    return calls, switches


def test_launch_takes_the_stream_of_the_tensors_device(stub_cuda):
    """A shard on cuda:1 launches on cuda:1's stream with cuda:1 current
    (its cudaFuncSetAttribute opt-ins apply there), whatever device is
    current: the pointers go in as they are, the stream last.  On the
    current device no device switch is made."""
    calls, switches = stub_cuda
    before = _cuda.LAUNCHES["stub"]
    _cuda.launch("paged_attention.cu", "pw_fn", "stub",
                 torch.device("cuda", 1), 4096, 8192, 7, 0.5)
    [(fn, args, current)] = calls
    assert fn == "pw_fn" and current == "cuda:1"
    assert args == (4096, 8192, 7, 0.5, 1001)
    assert switches == ["cuda:1"]
    _cuda.launch("paged_attention.cu", "pw_fn", "stub",
                 torch.device("cuda", 0), 16)
    assert calls[1] == ("pw_fn", (16, 1000), "cuda:0")
    assert switches == ["cuda:1"]
    assert _cuda.LAUNCHES["stub"] == before + 2


def test_launch_refuses_tensors_on_two_devices(stub_cuda, monkeypatch):
    """The wrappers hold every operand to the first one's device, so a
    launch never mixes devices: operands on two cards raise before it."""
    from pathway_tpu_torch.kvcache import paged_attention as pa
    from pathway_tpu_torch.ops.knn_cuda import knn_scores_cuda

    calls, _switches = stub_cuda
    with pytest.raises(ValueError, match="matrix is on cuda:1"):
        knn_scores_cuda(_OnCuda(torch.zeros((2, 32)), "cuda:0"),
                        _OnCuda(torch.zeros((8, 32)), "cuda:1"))
    q = _OnCuda(torch.zeros((1, 1, 2, 32)), "cuda:0")
    pool = torch.zeros((4, 4, 2, 32))
    with pytest.raises(ValueError, match="v_pool is on cuda:1"):
        pa.paged_attention_cuda(q, _OnCuda(pool, "cuda:0"),
                                _OnCuda(pool, "cuda:1"), None, None, None)
    assert not calls


def test_check_names_the_operand_on_another_device():
    t = _OnCuda(torch.zeros(4))
    _cuda.check(t, "x", device="cuda")
    with pytest.raises(ValueError, match="x is on cuda"):
        _cuda.check(t, "x", device="cuda:1")
