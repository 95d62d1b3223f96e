"""The (obj, z) sharded frame step over ``torch.distributed``: the rank
mesh and launcher (:mod:`.mesh`), the collectives (:mod:`.comm`) and the
z-sharded fusion and marching cubes (:mod:`.sharded_ops`). Port of
``emfusion_tpu/distributed/``."""
