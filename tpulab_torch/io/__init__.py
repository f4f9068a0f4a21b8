"""Image codecs and the stdin grammars of the lab suite (numpy only)."""

from tpulab_torch.io import protocol
from tpulab_torch.io.imagefile import load_image, save_image

__all__ = ["load_image", "protocol", "save_image"]
