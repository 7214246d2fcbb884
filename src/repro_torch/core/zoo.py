"""Paper benchmark DNN profiles: AlexNet, VGG19, GoogleNet, ResNet101.

The paper's github profile file is not available offline (DESIGN.md §2);
these DAGs are synthesized from the published architectures with compute
amounts in **CPU-seconds** (execution time on a 1-CPU server; the paper's
end devices have p = 2) and inter-layer datasets in **MB**, scaled so the
quoted anchors hold: AlexNet has 11 layers with max inter-layer dataset
< 1.1 MB and ~1-2 s per-layer device times (Table I ballpark); VGG19 is a
pure chain (prePSO collapses it to one layer); GoogleNet has inception
branching with ≈40-50% cut-edge compressibility; ResNet101 is deep
(~340 nodes counting conv/bn/relu/add as the paper does to reach
"more than 1000" across 3 DNNs per device) with skip edges.

Every DNN's input layer is pinned to its originating end-device server.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .dag import LayerDAG

__all__ = ["alexnet", "vgg19", "googlenet", "resnet101", "build", "NAMES"]

NAMES = ("alexnet", "vgg19", "googlenet", "resnet101")


class _Builder:
    def __init__(self) -> None:
        self.compute: List[float] = []
        self.edges: List[Tuple[int, int]] = []
        self.mb: List[float] = []
        self.names: List[str] = []

    def node(self, name: str, cpu_sec: float) -> int:
        self.names.append(name)
        self.compute.append(cpu_sec)
        return len(self.compute) - 1

    def edge(self, u: int, v: int, mb: float) -> None:
        self.edges.append((u, v))
        self.mb.append(mb)

    def chain(self, specs: List[Tuple[str, float, float]], start: int) -> int:
        """specs: (name, cpu_sec, incoming_mb); returns last node id."""
        prev = start
        for name, a, mb in specs:
            n = self.node(name, a)
            self.edge(prev, n, mb)
            prev = n
        return prev

    def dag(self, deadline: float, pin_server: int, app_id: int = 0
            ) -> LayerDAG:
        p = len(self.compute)
        pinned = np.full(p, -1, np.int32)
        pinned[0] = pin_server
        return LayerDAG(
            compute=np.asarray(self.compute),
            edges=np.asarray(self.edges, np.int32).reshape(-1, 2),
            edge_mb=np.asarray(self.mb),
            app_id=np.full(p, app_id, np.int32),
            deadline=np.asarray([deadline]),
            pinned=pinned, names=list(self.names))


def alexnet(pin_server: int = 0, deadline: float = np.inf) -> LayerDAG:
    """11 layers: input + 5 conv + 3 fc + softmax + output (pure chain)."""
    b = _Builder()
    inp = b.node("input", 0.05)
    b.chain([
        ("conv1", 1.30, 0.59),   # 227x227x3 uint8
        ("conv2", 2.10, 1.07),   # paper: max dataset < 1.1 MB
        ("conv3", 1.40, 0.71),
        ("conv4", 1.10, 0.50),
        ("conv5", 0.80, 0.38),
        ("fc6", 1.90, 0.21),
        ("fc7", 0.90, 0.031),
        ("fc8", 0.35, 0.016),
        ("softmax", 0.05, 0.004),
        ("output", 0.02, 0.004),
    ], inp)
    return b.dag(deadline, pin_server)


def vgg19(pin_server: int = 0, deadline: float = np.inf) -> LayerDAG:
    """25 nodes: input + 16 conv + 5 pool + 3 fc (chain; prePSO -> 1 node)."""
    b = _Builder()
    inp = b.node("input", 0.05)
    convs = [
        # (name, cpu_sec, incoming MB)
        ("conv1_1", 1.1, 0.59), ("conv1_2", 2.4, 12.3),
        ("pool1", 0.10, 12.3),
        ("conv2_1", 1.9, 3.1), ("conv2_2", 2.6, 6.2),
        ("pool2", 0.08, 6.2),
        ("conv3_1", 1.6, 1.5), ("conv3_2", 2.8, 3.1), ("conv3_3", 2.8, 3.1),
        ("conv3_4", 2.8, 3.1), ("pool3", 0.06, 3.1),
        ("conv4_1", 1.5, 0.77), ("conv4_2", 2.9, 1.5), ("conv4_3", 2.9, 1.5),
        ("conv4_4", 2.9, 1.5), ("pool4", 0.05, 1.5),
        ("conv5_1", 0.9, 0.38), ("conv5_2", 0.9, 0.38), ("conv5_3", 0.9, 0.38),
        ("conv5_4", 0.9, 0.38), ("pool5", 0.03, 0.38),
        ("fc6", 2.5, 0.10), ("fc7", 1.0, 0.016), ("fc8", 0.4, 0.016),
    ]
    b.chain(convs, inp)
    return b.dag(deadline, pin_server)


def googlenet(pin_server: int = 0, deadline: float = np.inf) -> LayerDAG:
    """Stem + 9 inception modules (4 parallel branches each) + classifier.

    Branch chains (1x1->3x3 etc.) are cut-edges; the merge ratio lands in
    the paper's ~48% ballpark.
    """
    b = _Builder()
    inp = b.node("input", 0.05)
    stem_end = b.chain([
        ("conv7x7", 1.2, 0.59), ("pool1", 0.08, 3.1),
        ("conv1x1", 0.5, 0.77), ("conv3x3", 1.5, 0.77),
        ("pool2", 0.06, 2.3),
    ], inp)

    def inception(prev: int, tag: str, scale: float, mb_in: float) -> int:
        # four branches from `prev`, concatenated
        b1 = b.node(f"{tag}_1x1", 0.35 * scale)
        b.edge(prev, b1, mb_in)
        r3 = b.node(f"{tag}_3x3r", 0.15 * scale)
        b.edge(prev, r3, mb_in)
        c3 = b.node(f"{tag}_3x3", 0.80 * scale)
        b.edge(r3, c3, mb_in * 0.6)
        r5 = b.node(f"{tag}_5x5r", 0.08 * scale)
        b.edge(prev, r5, mb_in)
        c5 = b.node(f"{tag}_5x5", 0.40 * scale)
        b.edge(r5, c5, mb_in * 0.15)
        pp = b.node(f"{tag}_pool", 0.05 * scale)
        b.edge(prev, pp, mb_in)
        pc = b.node(f"{tag}_poolproj", 0.10 * scale)
        b.edge(pp, pc, mb_in)
        cat = b.node(f"{tag}_concat", 0.02)
        b.edge(b1, cat, mb_in * 0.35)
        b.edge(c3, cat, mb_in * 0.45)
        b.edge(c5, cat, mb_in * 0.12)
        b.edge(pc, cat, mb_in * 0.18)
        return cat

    prev = stem_end
    mb = 1.2
    for i, (tag, scale) in enumerate([
            ("3a", 1.0), ("3b", 1.3), ("4a", 1.1), ("4b", 1.0), ("4c", 1.0),
            ("4d", 1.1), ("4e", 1.3), ("5a", 1.2), ("5b", 1.4)]):
        prev = inception(prev, tag, scale, mb)
        if tag in ("3b", "4e"):       # maxpool between stages
            pool = b.node(f"pool_{tag}", 0.05)
            b.edge(prev, pool, mb)
            prev = pool
            mb *= 0.55
    b.chain([("avgpool", 0.05, mb), ("fc", 0.30, 0.004),
             ("output", 0.02, 0.004)], prev)
    return b.dag(deadline, pin_server)


def resnet101(pin_server: int = 0, deadline: float = np.inf) -> LayerDAG:
    """Stem + 33 bottlenecks (conv/bn/relu expanded, residual adds) + head.

    ~341 nodes; conv-bn-relu chains are cut-edges, residual adds are not.
    """
    b = _Builder()
    inp = b.node("input", 0.05)
    prev = b.chain([("conv1", 0.9, 0.59), ("bn1", 0.05, 3.1),
                    ("relu1", 0.02, 3.1), ("pool1", 0.06, 3.1)], inp)
    stage_cfg = [(3, 1.0, 0.77), (4, 1.1, 0.42), (23, 1.0, 0.21),
                 (3, 1.3, 0.13)]
    for s_idx, (blocks, scale, mb) in enumerate(stage_cfg):
        for blk in range(blocks):
            tag = f"s{s_idx}b{blk}"
            entry = prev
            chain_end = b.chain([
                (f"{tag}_c1", 0.20 * scale, mb), (f"{tag}_bn1", 0.03, mb),
                (f"{tag}_r1", 0.01, mb),
                (f"{tag}_c2", 0.55 * scale, mb), (f"{tag}_bn2", 0.03, mb),
                (f"{tag}_r2", 0.01, mb),
                (f"{tag}_c3", 0.25 * scale, mb), (f"{tag}_bn3", 0.03, mb),
            ], entry)
            add = b.node(f"{tag}_add", 0.01)
            b.edge(chain_end, add, mb)
            b.edge(entry, add, mb)       # residual skip
            relu = b.node(f"{tag}_relu", 0.01)
            b.edge(add, relu, mb)
            prev = relu
    b.chain([("avgpool", 0.04, 0.13), ("fc", 0.25, 0.008),
             ("output", 0.02, 0.004)], prev)
    return b.dag(deadline, pin_server)


_BUILDERS = {"alexnet": alexnet, "vgg19": vgg19, "googlenet": googlenet,
             "resnet101": resnet101}


def build(name: str, pin_server: int = 0, deadline: float = np.inf
          ) -> LayerDAG:
    return _BUILDERS[name](pin_server=pin_server, deadline=deadline)
