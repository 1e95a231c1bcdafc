"""The IVF guarantee: every answer is the exact top-k of the rows in the
``nprobe`` lists whose centroids lie nearest the query (squared L2).

The reference builds its own inverted file from the raw corpus by the
recipe the workload's ``ivf_build`` states: a training sample of
``max_points_per_centroid * nlist`` rows, the first of ``randperm(n, seed
^ sample_seed_xor)`` (every row where there are fewer); the first
``nlist`` rows of ``randperm(n_train, seed)`` of it as the initial
centroids; ``iters`` Lloyd iterations; every row in the list of its
nearest centroid. The draws are plain ``torch.randperm`` on a CPU
generator, the same wherever they run; the arithmetic is the reference's
own.
"""

import re

import torch

from retrieval_bench.reference import exact_topk, kmeans, nearest, pairwise, permutation


def build(x, workload, fmt=None):
    recipe = workload["ivf_build"]
    n = x.shape[0]
    nlist = min(int(re.match(r"IVF(\d+),", recipe["index_key"]).group(1)), n)
    seed = int(recipe["seed"])
    train = x
    cap = int(recipe["max_points_per_centroid"]) * nlist
    if n > cap:
        train = x[permutation(n, seed ^ int(recipe["sample_seed_xor"]))[:cap].to(x.device)]
    init = train[permutation(train.shape[0], seed)[:nlist].to(x.device)]
    centroids = kmeans(train, init, int(recipe["iters"]), fmt)
    return {"x": x, "centroids": centroids, "lists": nearest(x, centroids, fmt),
            "nprobe": min(int(recipe["nprobe"]), nlist)}


def search(index, q, k, metric, fmt=None):
    c, lists = index["centroids"], index["lists"]
    _, near = torch.topk(pairwise(q, c, "l2", fmt), index["nprobe"], dim=1, largest=False)

    def probed_rows(a, b):
        probed = torch.zeros((b - a, c.shape[0]), dtype=torch.bool, device=q.device)
        probed.scatter_(1, near[a:b], True)
        return probed[:, lists]

    return exact_topk(q, index["x"], k, metric, fmt, row_mask=probed_rows)
