"""Every config the port ships has a CUDA instance for every kernel entry.

For each arch in ``ARCHS``, at its reduced config (what the training CLI,
the examples and the dry run build by default) and at its published one,
each call its full-sequence forward and ``train_forward`` make into a
kernel must lie inside the wrapper's reach: the ``reach_error`` of flash
attention (its predicate: head dims to ``MAX_HEAD_DIM``, float32,
bfloat16 or float16; a pair off ``HEAD_DIMS[dtype]`` runs on the smallest
instance that holds it), of the WKV kernel (head sizes to 128 and chunks
to ``MAX_CHUNK``, ``MAX_CHUNK_K128`` past 64) and of the selective scan
(any state size and chunk) has nothing against the call.  On the card a call
outside the reach raises, so a config added with a shape no instance takes
fails here, on the CPU, first.

The reduced configs' entries are recorded through the models' ``attend``
and ``scan`` seams on a CPU forward in the config's own dtype, and must
equal what :func:`kernel_entries` derives from the config's fields; the
published configs' entries (too large to run here) come from that helper.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_api  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import selective_scan_ref  # noqa: E402


def kernel_entries(cfg):
    """The kernel entries a config's forward reaches, from its fields: a set
    of ``("flash", dtype, Dqk, Dv)`` (attention in the compute dtype; MLA's
    q/k are the latent and RoPE parts, v its own width), ``("wkv", K,
    chunk)`` (float32 whatever the config's dtype: rwkv6 widens r, k and v
    before the call, as the reference does) and ``("scan", dtype, N,
    chunk)`` (in the compute dtype: hymba hands the kernel its tensors as
    they are)."""
    if cfg.family == "ssm":
        return {("wkv", cfg.head_size, cfg.wkv_chunk)}
    entries = set()
    if cfg.family == "hybrid":
        entries.add(("scan", cfg.compute_dtype, cfg.ssm_state, cfg.ssm_chunk))
    if hasattr(cfg, "qk_nope_dim"):
        dims = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
    else:
        dims = (cfg.head_dim, cfg.head_dim)
    entries.add(("flash", cfg.compute_dtype, *dims))
    return entries


def recorded_entries(api):
    """The entries one CPU ``train_forward`` of ``api``'s config (seeded
    weights, B=2, S=32, its own dtype) makes, recorded through its seams;
    each seam computes the plain version, so the forward runs as it would."""
    cfg = api.cfg
    seen = set()

    def attend(*, causal):
        def seam(q, k, v, **mask):
            seen.add(("flash", q.dtype, q.shape[-1], v.shape[-1]))
            return attention_ref(q, k, v, **{"causal": causal, "window": cfg_window, **mask})
        return seam

    def scan(*args, chunk):
        if cfg.family == "ssm":
            seen.add(("wkv", args[0].shape[-1], chunk))
            return wkv_chunked(*args, chunk=chunk)
        u, dt, b_t, c_t, log_a = args
        seen.add(("scan", u.dtype, b_t.shape[-1], chunk))
        return selective_scan_ref(u, dt, log_a, b_t, c_t)

    cfg_window = getattr(cfg, "window", None) if cfg.family in ("dense", "moe") else None
    model = api.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    if cfg.family == "audio":
        audio = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=gen)
        seams = dict(enc_attend=attend(causal=False), self_attend=attend(causal=True),
                     cross_attend=attend(causal=False))
        inputs = (audio.to(cfg.compute_dtype), tokens)
    elif cfg.family == "ssm":
        seams, inputs = dict(scan=scan), (tokens,)
    elif cfg.family == "hybrid":
        seams, inputs = dict(attend=attend(causal=True), scan=scan), (tokens,)
    else:
        seams, inputs = dict(attend=attend(causal=True)), (tokens,)
    with torch.no_grad():
        model.train_forward(*inputs, **seams)
    return seen


def uncovered(entries):
    """The entries no CUDA instance takes, each with the limit it passed."""
    missing = []
    for kind, *dims in sorted(entries, key=str):
        if kind == "flash":
            dtype, dqk, dv = dims
            why = flash_ops.reach_error(dtype, dqk, dv)
            if why:
                missing.append(f"flash {dtype} {(dqk, dv)}: {why}")
        elif kind == "wkv":
            k, chunk = dims
            why = wkv_ops.reach_error(torch.float32, k, chunk)
            if why:
                missing.append(f"wkv K={k} chunk={chunk}: {why}")
        else:
            dtype, n, chunk = dims
            why = ssm_ops.reach_error(dtype, n, chunk)
            if why:
                missing.append(f"scan {dtype} N={n} chunk={chunk}: {why}")
    return missing


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one thread: the suite runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("width", ["reduced", "published"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_kernel_entry_has_a_cuda_instance(arch, width):
    api = get_api(arch, reduced=width == "reduced")
    entries = kernel_entries(api.cfg)
    if width == "reduced":
        assert recorded_entries(api) == entries
    assert entries and not uncovered(entries), uncovered(entries)


@pytest.mark.parametrize("entry,table", [
    (("flash", torch.bfloat16, 320, 320), "MAX_HEAD_DIM"),
    (("flash", torch.float64, 64, 64), "DTYPES"),
    (("wkv", 160, 16), "HEAD_SIZES"),
    (("wkv", 64, 256), "MAX_CHUNK"),
    (("wkv", 128, 96), "MAX_CHUNK_K128"),
    (("scan", torch.float64, 16, 8), "DTYPES"),
])
def test_an_uncovered_entry_is_named(entry, table):
    """A shape outside the reach is reported with the limit it passed."""
    (missing,) = uncovered({entry})
    assert table in missing


def test_kernel_entries_reads_the_mla_and_hybrid_fields():
    """The helper's two special cases: MLA's (Dqk, Dv) and the hybrid's
    attention plus scan, at the published configs."""
    ds = get_api("deepseek-v2-236b").cfg
    assert kernel_entries(ds) == {("flash", ds.compute_dtype, 192, 128)}
    hy = get_api("hymba-1.5b").cfg
    assert kernel_entries(hy) == {("flash", hy.compute_dtype, 64, 64),
                                  ("scan", hy.compute_dtype, 16, 128)}
