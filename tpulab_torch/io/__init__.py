"""Image codecs, the lab5 typed-array format and the stdin grammars of the
lab suite (numpy only)."""

from tpulab_torch.io import protocol
from tpulab_torch.io.binfmt import load_typed_array, save_typed_array
from tpulab_torch.io.imagefile import load_image, save_image

__all__ = ["load_image", "load_typed_array", "protocol", "save_image", "save_typed_array"]
