"""The one generator of every traffic mix: problems from a seed.

A configuration file (``benchmark/configs/<name>.json``) fixes the
deployment: its ``protocol`` ("bunny": the upstream Monte-Carlo
registration benchmark over a point cloud), its noise and its invariant. A traffic file
(``benchmark/traffic/<name>.json``) fixes the mix: problems a request,
m, the outlier ratio, how many distinct requests the set-up makes and
the seed of the bank of problems they hold. :func:`make_requests` turns
the pair and a run's seed into the requests, as NumPy arrays: every seed
gives the same problems, in its own order and from its own starts.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import numpy as np

from benchmark.traffic import data

TRAFFIC_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Request:
    """One request's problems: D1 (n1, d) shared, D2s (W, n2, d), As
    (W, m, 2) int32, Agts the W ground-truth arrays, and u0s (W, m)
    float32, the solver's initial vectors, uniform in [0, 1) as upstream
    draws them."""
    D1: np.ndarray
    D2s: np.ndarray
    As: np.ndarray
    Agts: List[np.ndarray]
    u0s: np.ndarray


def load_traffic(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def load_cloud(config: dict) -> np.ndarray:
    pts = data.read_ply(data.DATA_DIR / config["cloud"])
    if pts.shape[0] != config["points"]:
        raise ValueError(f"{config['cloud']} holds {pts.shape[0]} points, "
                         f"the configuration says {config['points']}")
    return data.scale_to_cube(pts, config["scale"])


def _bunny_problems(rng, pcd0, W, m, rho, config, workers):
    """W problems of the bunny protocol: the noisy clouds drawn in turn,
    their ground truth worked out on ``workers`` threads, then the
    associations drawn in turn (so the draws do not depend on
    ``workers``)."""
    sigma = config["noise_sigma"]
    beta = config["noise_beta_sigmas"] * sigma
    n = pcd0.shape[0]
    pcd1s = [pcd0 + data.bounded_normal_noise(rng, n, sigma, beta)
             for _ in range(W)]
    with ThreadPoolExecutor(max(1, workers)) as ex:
        goods = list(ex.map(
            lambda p: data.nearest_correspondences(pcd0, p, beta), pcd1s))
    return [(p, *data.synthetic_correspondences(rng, n, n, g, m, rho))
            for p, g in zip(pcd1s, goods)]


def make_requests(config: dict, traffic: dict, seed: int,
                  workers: int = 1) -> List[Request]:
    """traffic["distinct_requests"] requests of traffic["problems"]
    problems each, in float32. The problems and the solver's initial
    vector of each are the traffic's bank, drawn from its ``bank_seed``;
    ``seed`` (any non-negative integer) draws the order in which they come
    and which of them share a request. So every seed does the same work
    in another order. ``workers`` threads work out the bunny protocol's
    ground truth (the draws do not depend on it)."""
    bank = np.random.default_rng(np.random.SeedSequence(
        [traffic["bank_seed"], 1]))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    W, m, rho = traffic["problems"], traffic["m"], traffic["rho"]
    n = W * traffic["distinct_requests"]
    if config["protocol"] != "bunny":
        raise ValueError(f"unknown protocol {config['protocol']!r}")
    pcd0 = load_cloud(config)
    probs = _bunny_problems(bank, pcd0, n, m, rho, config, workers)
    u0s = bank.random((n, m), dtype=np.float32)
    order = rng.permutation(n)
    out = []
    for r in range(traffic["distinct_requests"]):
        take = order[r * W:(r + 1) * W]
        D2s = np.stack([probs[i][0] for i in take]).astype(np.float32)
        As = np.stack([probs[i][1] for i in take]).astype(np.int32)
        out.append(Request(pcd0.astype(np.float32), D2s, As,
                           [probs[i][2] for i in take], u0s[take]))
    return out


def problem(req: Request, w: int):
    """(D1, D2, A) of problem w of a request, as (n, d) and (m, 2)."""
    return req.D1, req.D2s[w], req.As[w]
