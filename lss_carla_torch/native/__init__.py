"""Native (C++) host-pipeline components, loaded with ctypes: the port's
own copy of ``lss_carla_tpu/native``.

The library builds on first use (g++ and Pillow's bundled libjpeg) into
``lss_carla_torch/_build/``; a build that fails raises.
"""

from lss_carla_torch.native.fastimage import (  # noqa: F401
    decode_crop_normalize, decode_crop_u8, decode_resize_crop_normalize,
    decode_resize_crop_u8, jpeg_dims)
