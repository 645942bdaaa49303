"""The convolutions of ResNet-50 v2 (slim's resnet_v2_50) from its shapes:
for a frame of S x S, every conv's map size, channels, kernel and stride.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

BLOCKS = ((3, 256, 64), (4, 512, 128), (6, 1024, 256), (3, 2048, 512))


class Conv(NamedTuple):
    name: str        # "root", or "<unit>/shortcut|conv1|conv2|conv3"
    h: int           # input map height (= width)
    cin: int
    cout: int
    k: int           # kernel size
    stride: int
    unit: int        # 0 for the root, else the unit's number, 1-16
    last: bool       # the unit's last conv (conv3)

    @property
    def ho(self) -> int:
        return -(-self.h // self.stride)

    def macs(self) -> int:
        """Multiply-adds per frame."""
        return self.ho * self.ho * self.cout * self.cin * self.k * self.k


def _same(size: int, stride: int) -> int:
    return -(-size // stride)


def convs(size: int = 224) -> Iterator[Conv]:
    """The root 7x7/2, then per unit its projection shortcut (the first
    unit of each block), conv1 1x1, conv2 3x3 (stride 2 at the last unit of
    blocks 1-3) and conv3 1x1, in order."""
    h = _same(size, 2)
    yield Conv("root", size, 3, 64, 7, 2, 0, False)
    h = _same(h, 2)                       # the 3x3/2 "SAME" max pool
    depth_in, unit = 64, 0
    for bi, (n, depth, db) in enumerate(BLOCKS, 1):
        for ui in range(1, n + 1):
            unit += 1
            stride = 2 if ui == n and bi < len(BLOCKS) else 1
            pre = f"block{bi}/unit_{ui}"
            if depth != depth_in:
                yield Conv(pre + "/shortcut", h, depth_in, depth, 1, 1, unit, False)
            yield Conv(pre + "/conv1", h, depth_in, db, 1, 1, unit, False)
            yield Conv(pre + "/conv2", h, db, db, 3, stride, unit, False)
            ho = _same(h, stride)
            yield Conv(pre + "/conv3", ho, db, depth, 1, 1, unit, True)
            h, depth_in = ho, depth


def pool_size(size: int = 224) -> int:
    return _same(_same(size, 2), 2)
