"""Which CUDA kernel each ``update_apply`` call takes, how the vec route
splits its flat run, and that the CPU path takes neither.

``colnorm._route`` picks the kernel of a CUDA call from the operands'
dtypes, shapes, strides and addresses alone: ``vec`` (16-byte vectors over
the flat run) where theta and g are contiguous and reach a 16-byte
boundary at the same element, ``strided`` for every other layout. It is a
pure function, so it is checked here on CPU tensors, whose allocations are
16-byte aligned; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``).

Imports no JAX: the routes are the port's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.colnorm import colnorm as C  # noqa: E402
from repro_torch.kernels.colnorm import ref as CR  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (theta dtype, g dtype): the hidden leaves, the head (theta and its f32
# momentum m'), the f32 model, and f32 theta with a bf16 gradient
PAIRS = [("bf16", "bf16"), ("bf16", "f32"), ("f32", "f32"), ("f32", "bf16")]
SHAPES = {"ragged_3x77x129": (3, 77, 129), "w_gate_row_1x3x5461": (1, 3, 5461),
          "head_1x16x32000": (1, 16, 32000)}


def _at(shape, dtype, offset=0):
    """A contiguous (L, m, n) view ``offset`` elements into a fresh buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset, dtype=DTYPES[dtype])
    return buf[offset:].view(shape)


def _aligned(t):
    assert t.data_ptr() % 16 == 0  # the CPU allocator's alignment
    return t


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_vec_for_contiguous_coaligned_operands(pair, shape):
    """Fresh contiguous operands of every dtype pair take vec, with no
    head; and so does a leaf's canonical view (2-D leaves get a unit layer
    axis)."""
    th, g = (_aligned(_at(SHAPES[shape], d)) for d in pair)
    assert C._route(th, g) == "vec"
    assert C.vec_head(th, g) == 0
    assert C.vec_width(th, g) == (4 if pair == ("f32", "f32") else 8)
    leaf = torch.zeros(SHAPES[shape][1:], dtype=DTYPES[pair[0]])
    assert C._route(C.canon3(leaf), C.canon3(torch.zeros_like(
        leaf, dtype=DTYPES[pair[1]]))) == "vec"


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_vec_at_a_common_offset(pair, offset):
    """Views at the same element offset into their buffers reach a 16-byte
    boundary together, after the elements left to the next boundary: the
    ragged head."""
    th, g = (_at((3, 77, 129), d, offset) for d in pair)
    w = C.vec_width(th, g)
    assert C._route(th, g) == "vec"
    assert C.vec_head(th, g) == (-offset) % w
    for t in (th, g):
        assert (t.data_ptr() + C.vec_head(th, g) * t.element_size()) % 16 == 0


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_strided_for_a_transposed_view(pair):
    """The same values laid out transposed in memory, viewed back as (L,
    m, n): not contiguous, so strided, whichever operand it is."""
    shape = (3, 77, 129)
    th, g = (_at(shape, d) for d in pair)
    tt = torch.zeros((3, 129, 77), dtype=th.dtype).transpose(1, 2)
    gt = torch.zeros((3, 129, 77), dtype=g.dtype).transpose(1, 2)
    assert tt.shape == shape and not tt.is_contiguous()
    assert C._route(tt, g) == "strided"
    assert C._route(th, gt) == "strided"
    assert C._route(tt, gt) == "strided"


@pytest.mark.parametrize("offset", [1, 3, 5, 7])
def test_strided_for_theta_alone_at_an_odd_offset(offset):
    """A slice view of theta at an odd storage offset, g fresh: the two
    never reach a 16-byte boundary at the same element."""
    th = _at((3, 77, 129), "bf16", offset)
    g = _at((3, 77, 129), "bf16")
    assert th.storage_offset() == offset and th.is_contiguous()
    assert C._route(th, g) == "strided"
    assert C.vec_head(th, g) is None


@pytest.mark.parametrize("offsets", [(1, 2), (2, 1), (0, 1), (3, 6)],
                         ids=lambda o: f"{o[0]}-{o[1]}")
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_strided_for_mismatched_offsets(pair, offsets):
    """theta and g at different offsets into their buffers, whose 16-byte
    boundaries fall at different elements: strided, for every dtype pair."""
    th = _at((3, 77, 129), pair[0], offsets[0])
    g = _at((3, 77, 129), pair[1], offsets[1])
    assert C.vec_head(th, g) is None
    assert C._route(th, g) == "strided"


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_vec_for_offsets_a_whole_vector_apart(pair):
    """Offsets that differ by one vector (16 bytes of the narrower operand)
    leave the two misaligned alike: vec, with the head of the smaller
    offset."""
    w = 4 if pair == ("f32", "f32") else 8
    th = _at((3, 77, 129), pair[0], 1)
    g = _at((3, 77, 129), pair[1], 1 + w)
    assert C._route(th, g) == "vec"
    assert C.vec_head(th, g) == w - 1


def test_strided_from_two_to_the_31_elements():
    """The vec route's flat offsets are 32-bit: a contiguous tensor of 2**31
    elements goes strided (meta tensors: nothing is allocated, and the
    choice reads no address past the size test)."""
    big = torch.empty((2, 2**30), dtype=torch.bfloat16, device="meta")
    assert big.is_contiguous() and big.numel() == 2**31
    assert C._route(C.canon3(big), C.canon3(big)) == "strided"
    th = torch.zeros(1, dtype=torch.bfloat16).expand(4, 5)
    assert not th.is_contiguous()
    assert C._route(C.canon3(th), C.canon3(th)) == "strided"


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [129, 5461])
@pytest.mark.parametrize("width", [4, 8])
def test_vec_split_covers_every_element_once(width, n, offset):
    """head + vectors * width + tail is the whole run, with head and tail
    shorter than a vector, for ragged rows and every offset; marking each
    part's elements in turn marks each element exactly once."""
    for L, m in ((1, 1), (3, 77), (2, 3)):
        numel = L * m * n
        head = (-offset) % width
        h, nvec, tail = C.vec_split(numel, head, width)
        assert h == head and 0 <= tail < width and nvec >= 0
        hits = np.zeros(numel, dtype=np.int64)
        hits[:h] += 1
        hits[h:h + nvec * width] += 1
        hits[h + nvec * width:h + nvec * width + tail] += 1
        assert (hits == 1).all() and h + nvec * width + tail == numel


@pytest.mark.parametrize("numel", [1, 3, 7, 8, 9])
def test_vec_split_of_runs_shorter_than_the_head(numel):
    """A run no longer than the head goes element by element."""
    h, nvec, tail = C.vec_split(numel, 7, 8)
    assert h == min(7, numel) and nvec == 0 and h + tail == numel


@pytest.mark.parametrize("axis", ["col", "row"])
def test_cpu_update_apply_is_the_plain_version_and_counts_no_route(axis):
    """On CPU tensors update_apply is update_apply_ref, bit for bit and in
    place, and launches nothing on either route."""
    rng = np.random.default_rng(0)
    th0, g0 = (torch.from_numpy(rng.standard_normal(
        (3, 77, 129), dtype=np.float32)).to(torch.bfloat16) for _ in range(2))
    ss = CR.norm_sumsq_ref(g0, axis)
    before = (C.update_apply.launches, dict(C.update_apply.route_launches))
    th = th0.clone()
    got = C.update_apply(th, g0, ss, 0.01, axis, gscale=0.37)
    want = CR.update_apply_ref(th0.clone(), g0, ss, 0.01, axis, gscale=0.37)
    assert got is th and torch.equal(got, want)
    assert (C.update_apply.launches,
            C.update_apply.route_launches) == before
    assert set(C.update_apply.route_launches) == {"vec", "strided"}
