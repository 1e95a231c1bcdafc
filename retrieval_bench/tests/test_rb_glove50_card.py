"""On the card, at the published size of ``glove50``: the port's graph
index against the plain block beam on its own layout, and K2 at the
cell's shape against its plain version. Skips on a host without a card.
Run on the card with

    python -m pytest retrieval_bench/tests/test_rb_glove50_card.py -q -s

Each test prints one ``glove50_card {json}`` line with its counts.
"""

import json

import numpy as np
import pytest
import torch

from retrieval_bench import harness
from retrieval_bench import plain_block_beam as plain

CELL = "glove50.hnsw"
TIE_REL = 2.0 ** -21  # the probes' agree_where_distinct rule
SEED = 2**33 + 11


def _emit(**numbers):
    print("glove50_card " + json.dumps(numbers), flush=True)


@pytest.mark.card
def test_the_program_walks_as_the_plain_beam_at_the_published_size(card):
    from vectordb_retrieval_tpu_torch.models import graph as gm
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import graph as gops
    from vectordb_retrieval_tpu_torch.ops import kernels

    cell = harness.load_cell(CELL)
    cfg, wl = cell["config"], cell["workload"]
    corpus, pool = harness.make_data(cfg, SEED)
    algo = harness.program(cell, card)
    algo.build_index(corpus)
    art = algo.artifact
    layout, meta = art.data, art.metadata
    assert meta["mode"] == "block" and meta["n_vectors"] == cfg["n"]
    batch, k = int(wl["batch"]), int(wl["k"])
    got_d, got_i = algo.batch_search(pool[:batch], k)

    x = dops.normalize(torch.as_tensor(corpus, device=card))
    q = dops.normalize(torch.as_tensor(pool[:batch], device=card))
    checks = plain.check_layout(layout, x)
    ef = int(wl["algorithm"]["searcher"]["efSearch"])
    efb, expand, iters = gm.block_geometry(meta["n_blocks"], ef, k, meta["block_len"])
    beam = gops.BlockBeam(q, layout["entries"], layout["entry_block"], layout["slot_ids"],
                          layout["list_vecs"], layout["list_sqnorms"], layout["entry_adj"],
                          layout.get("list_mu"), k=k, efb=efb, expand=expand, iters=iters,
                          metric="ip")
    st, pops, k2_err, k2_scale = beam.seed(), [], 0.0, 0.0
    for t in range(iters):
        st, p = beam.pop(st, t)
        pops.append(torch.where(p.sel_valid, p.sel_entries, -1).tolist())
        dots = beam.score(p)
        want = kernels.slab_dots_reference(beam.q, layout["list_vecs"], p.safe_blk)
        k2_err = max(k2_err, float((dots - want).abs().max()))
        k2_scale = max(k2_scale, float(want.abs().max()))
        st = beam.merge(st, p, dots)
        if t < iters - 1:
            st = beam.push(st, p)
    stage_d, stage_i = beam.result(st)

    ref_d, ref_i, ref_pops = plain.walk(layout, q, k + 1, efb, expand, iters, "ip")
    same_pop, explained = [], 0
    for j in range(batch):
        prog = [sorted(e for e in pops[t][j] if e >= 0) for t in range(iters)]
        ref = [sorted(w) for w in ref_pops[j]]
        same_pop.append(prog == ref)
        if prog != ref:
            t = next(t for t in range(iters) if prog[t] != ref[t])
            explained += plain.near_ties(layout, q[j], sorted(set(prog[t]) - set(ref[t])),
                                         sorted(set(ref[t]) - set(prog[t])), "ip", TIE_REL)
    same_pop = np.array(same_pop)
    certain = plain.certain(ref_d, TIE_REL).numpy()
    agree = got_i == ref_i[:, :k].numpy()
    counted = certain & same_pop[:, None]
    dist_err = float(np.abs(got_d - ref_d[:, :k].numpy()).max())
    _emit(test="walk", n=cfg["n"], geometry=[efb, expand, iters], n_blocks=meta["n_blocks"],
          n_entries=meta["n_entries"], block_len=meta["block_len"],
          selfcheck_recall=meta.get("selfcheck_recall"), checks=checks,
          queries=batch, pops_differ=int((~same_pop).sum()), pops_explained=int(explained),
          certain_ranks=int(counted.sum()), certain_disagree=int((counted & ~agree).sum()),
          uncertain_ranks=int((~certain).sum()), max_dist_err=dist_err,
          stages_equal_search=bool(np.array_equal(stage_i.cpu().numpy(), got_i)),
          k2_max_abs_err=k2_err, k2_max_abs_plain=k2_scale)
    assert checks == dict.fromkeys(checks, True)
    assert explained == int((~same_pop).sum())
    assert not (counted & ~agree).any()
    assert dist_err <= 1e-5
    assert k2_err <= 1e-5 * k2_scale


@pytest.mark.card
def test_k2_at_the_cells_shape_matches_its_plain_version(card):
    from vectordb_retrieval_tpu_torch.ops import kernels

    b, w, length, d, nb = 256, 96, 256, 50, 4624
    g = torch.Generator(device=card).manual_seed(23)
    q = torch.randn((b, d), generator=g, device=card)
    lv = torch.randn((nb, length, d), generator=g, device=card).to(torch.bfloat16)
    sel = torch.randint(0, nb, (b, w), generator=g, device=card)
    sel[0, 0], sel[-1, -1] = 0, nb - 1  # both ends of the id range
    sel[1] = sel[0]  # two queries popping the same slabs
    sel[:, 1] = sel[:, 0]  # a slab popped twice in a row
    got = kernels.slab_dots(q, lv, sel)
    want = kernels.slab_dots_reference(q, lv, sel)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    _emit(test="k2", shape=[b, w, length, d], n_blocks=nb, max_abs_err=err, max_abs_plain=scale)
    assert not torch.isnan(got).any()
    assert err <= 1e-5 * scale
