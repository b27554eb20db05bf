"""The parallel modes: data parallel (``step.py``) and camera parallel
(``camera.py``) over ranks laid out by ``mesh.py``, one process a device;
``dryrun.py`` drives them on the CPU with gloo ranks."""

from lss_carla_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, make_mesh_2d, replicate, shard_batch)
from lss_carla_torch.parallel.step import (  # noqa: F401
    make_sharded_train_step, make_sharded_eval_step)
from lss_carla_torch.parallel.camera import (  # noqa: F401
    make_camera_sharded_predict, make_camera_sharded_train_step,
    make_camera_sharded_eval_step)
