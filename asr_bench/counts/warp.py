"""Bytes the copies' warp needs: each input image read once, every copy
written once, both in the compute dtype."""


def copies_warp_bytes(images: int, copies: int, height: int, width: int,
                      channels: int = 3, itemsize: int = 2) -> int:
    return images * (1 + copies) * channels * height * width * itemsize
