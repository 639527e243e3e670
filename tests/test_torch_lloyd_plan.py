"""The Lloyd kernel's plan: which path a shape takes, and what it needs.

``ops/lloyd.plan(d, k, dtype)`` picks the kernel's path from the shape and
type alone (the kernel runs only on the card; ``chip_smoke.py`` phase 2
holds each path against the plain version there and checks that the CUDA
source's ``cdrs_lloyd_plan_info`` gives the shared memory that
``wgmma_layout`` does).  Here the choice is held for each shape class:
small shapes, rows that are not a whole number of 16-byte units (TMA's row
stride: d % 4 for f32, d % 8 for bf16), tiles too wide for a block, c
resident or streamed, f32 and bf16.  ``wgmma_layout``'s shared memory is
held to what each ring slot and c chunk adds, and at two shapes to the
byte counts worked by hand.  The scratch a call takes is the CUDA
source's: the wrapper asks ``plan_info`` for it on both general paths.
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

from cdrs_tpu_torch.ops import lloyd  # noqa: E402
from cdrs_tpu_torch.ops.lloyd import (SMEM_MAX, WG_CENTROIDS, WG_CONSUMERS,  # noqa: E402
                                      WG_ROWS, Plan, plan, wgmma_layout)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("d,k,dtype,path,resident", [
    (5, 8, F32, "small", None),          # the pipeline's shape
    (8, 16, BF16, "small", None),
    (5, 64, F32, "mma_sync", None),      # entry()'s k: 20-byte rows
    (37, 150, BF16, "mma_sync", None),   # 74-byte rows
    (12, 40, BF16, "mma_sync", None),    # 24-byte rows: d % 8 != 0 in bf16
    (300, 33, F32, "mma_sync", None),    # a 256-row tile of x takes 300 KB
    (32, 128, F32, "wgmma", 1),             # config 2: c (hi and lo) resident
    (32, 128, BF16, "mma_sync", None),   # bf16 with c resident: mma_sync was faster
    (128, 1024, F32, "wgmma", 0),           # config 3: c streamed, sums sorted
    (128, 1024, BF16, "wgmma", 0),          # the rehearsal's rows
    (12, 40, F32, "wgmma", 1),              # 48-byte rows: 64-byte swizzle
    (16, 17, BF16, "mma_sync", None),       # 32-byte rows, c resident
    (8, 17, F32, "wgmma", 1),               # d <= 8 but k > 16
    (64, 64, F32, "wgmma", 1),
    (64, 2048, BF16, "wgmma", 0),
])
def test_plan_picks_the_path_of_each_shape_class(d, k, dtype, path, resident):
    p = plan(d, k, dtype)
    assert p.path == path
    if path == "wgmma":
        assert p.resident == resident
        assert wgmma_layout(d, k, 2 if dtype == BF16 else 4, p) is not None
        assert p.as_ints() == [lloyd.PATHS["wgmma"], p.cstages, p.xstages, p.resident]


def test_plan_depends_on_shape_and_type_only():
    # No n, no n_valid, no pointer: the path of a call never depends on how
    # many rows it has or how many of them count.
    assert list(inspect.signature(plan).parameters) == ["d", "k", "dtype"]
    assert plan(128, 1024, F32) == plan(128, 1024, F32)
    assert plan(128, 1024, F32) != plan(128, 1024, BF16)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_layout_matches_the_cuda_formulas_and_fits(dtype):
    # csrc/lloyd_wgmma.cuh's layout(): a row tile of x in the ring takes
    # WG_ROWS x cb x nfc bytes and two barriers a chunk; a c chunk of the
    # streamed ring takes parts x WG_CENTROIDS x cb bytes (TF32 high and
    # low parts for f32) and two barriers; resident c takes every chunk.
    esz = 2 if dtype == BF16 else 4
    parts = 2 if dtype == F32 else 1
    seen = 0
    for d in (4, 8, 12, 16, 24, 32, 40, 64, 96, 128, 160, 200):
        for k in (17, 40, 64, 128, 150, 512, 1024, 3000):
            for cand in [Plan("wgmma", cs, xs, res)
                         for cs, xs, res in ((1, 2, 1), (2, 1, 0), (4, 1, 0), (12, 1, 0))]:
                lay = wgmma_layout(d, k, esz, cand)
                if (d * esz) % 16:
                    assert lay is None, (d, k, cand)
                    continue
                if lay is None:
                    continue
                seen += 1
                assert lay.smem <= SMEM_MAX and (9 * k + WG_CONSUMERS) * 4 <= lay.smem
                assert lay.cb * (lay.nfc - 1) < d * esz <= lay.cb * lay.nfc
                chunk = parts * WG_CENTROIDS * lay.cb
                more_x = wgmma_layout(d, k, esz, cand._replace(xstages=cand.xstages + 1))
                if more_x is not None:
                    assert more_x.smem - lay.smem == WG_ROWS * lay.cb * lay.nfc + 16 * lay.nfc
                if cand.resident:
                    ntc = -(-k // WG_CENTROIDS)
                    streamed = wgmma_layout(d, k, esz, Plan("wgmma", 2, cand.xstages, 0))
                    if streamed is not None:
                        assert lay.smem - streamed.smem == (ntc * lay.nfc - 2) * chunk - 16
                else:
                    more_c = wgmma_layout(d, k, esz, cand._replace(cstages=cand.cstages + 1))
                    if more_c is not None:
                        assert more_c.smem - lay.smem == chunk + 16
    assert seen > 50


def test_layout_byte_counts_by_hand():
    # 1M x 128, k = 1024, f32: one 256-row tile of x (4 chunks of 256 x 128
    # bytes = 131072) and 3 c chunks of 2 x 128 x 128 (32768 each): 229376;
    # barriers (2 x 4 + 2 x 3) x 8 = 112; 1024 to align: 230512 bytes.
    p = plan(128, 1024, F32)
    assert p == Plan("wgmma", 3, 1, 0)
    assert wgmma_layout(128, 1024, 4, p) == (230512, 128, 4)
    # 1M x 32, k = 128, f32: 4 row tiles of 256 x 128 bytes (131072), c
    # resident (1 x 1 chunks of 2 x 128 x 128 = 32768), barriers (2 x 4 + 2)
    # x 8 = 80, 1024: 164944 bytes.
    p = plan(32, 128, F32)
    assert p == Plan("wgmma", 1, 4, 1)
    assert wgmma_layout(32, 128, 4, p) == (164944, 128, 1)
    # The same shape in bf16 would fit resident, and so takes mma_sync.
    assert wgmma_layout(32, 128, 2, Plan("wgmma", 1, 4, 1)) is not None
    assert plan(32, 128, BF16).path == "mma_sync"


def test_plan_prefers_resident_c_then_two_row_tiles_then_the_deepest_ring():
    # c resident wherever it fits beside two row tiles; streamed c beside
    # two row tiles where the ring still holds four chunks and two centroid
    # tiles; else beside one, with the most chunks in flight that fit.
    assert plan(64, 64, F32).resident == 1
    p = plan(128, 1024, BF16)
    assert (p.resident, p.xstages, p.cstages) == (0, 2, 6)
    assert wgmma_layout(128, 1024, 2, p._replace(cstages=7)) is None
    p = plan(128, 1024, F32)   # a row tile of f32 x takes 128 KB: one
    assert (p.resident, p.xstages) == (0, 1)
    assert wgmma_layout(128, 1024, 4, p._replace(cstages=p.cstages + 1)) is None
    # A ring needs two chunks at least: one in use, one coming.
    assert wgmma_layout(256, 1024, 2, Plan("wgmma", 1, 1, 0)) is None
    assert wgmma_layout(256, 1024, 2, Plan("wgmma", 2, 1, 0)) is not None
    assert WG_CONSUMERS == 256


def test_shape_info_of_wgmma_and_small_paths_needs_no_library(monkeypatch):
    # The small path needs no scratch and asks the library nothing; both
    # general paths take their scratch from the CUDA source's plan_info
    # (here a stand-in, since the library is built only on the card), and
    # a plan the CUDA source refuses raises rather than run.
    asked = []

    def info(d, k, dtype, p):
        asked.append((d, k, dtype, p))
        return None if k == 77 else (1000 + k, 1, 200_000)

    monkeypatch.setattr(lloyd, "plan_info", info)
    monkeypatch.setattr(lloyd, "_SHAPES", {})
    p, arg, keeps, extra = lloyd._shape_info(5, 8, F32)
    assert (p.path, keeps, extra) == ("small", False, 0) and asked == []
    p, arg, keeps, extra = lloyd._shape_info(128, 1024, BF16)
    assert p.path == "wgmma" and (keeps, extra) == (True, 2024)
    assert list(arg) == p.as_ints()
    assert asked == [(128, 1024, BF16, p)]
    p, _, keeps, extra = lloyd._shape_info(300, 33, F32)
    assert p.path == "mma_sync" and (keeps, extra) == (True, 1033)
    with pytest.raises(ValueError, match="refuses"):
        lloyd._shape_info(128, 77, F32)


def test_breakdown_variants_find_their_source_text():
    # tools/lloyd_breakdown.py builds the kernel with source substitutions
    # (no sums, one product, no products, no ranking): each must find its
    # text exactly once, or the tool stops before it builds anything.
    import importlib.util
    from pathlib import Path

    tool = Path(__file__).resolve().parent.parent / "tools" / "lloyd_breakdown.py"
    spec = importlib.util.spec_from_file_location("lloyd_breakdown", tool)
    lb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lb)
    sources = {p.name: p.read_text() for p in [lb.SRC / "lloyd.cu", *lb.SRC.glob("*.cuh")]}
    assert set(lb.VARIANTS) >= {"as_is", "no_sums", "one_product", "no_products", "no_rank"}
    for name, subs in lb.VARIANTS.items():
        texts = dict(sources)
        for fname, old, new in subs:
            assert texts[fname].count(old) == 1, (name, fname, old[:60])
            texts[fname] = texts[fname].replace(old, new)
