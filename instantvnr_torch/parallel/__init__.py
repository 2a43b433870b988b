from instantvnr_torch.parallel.mesh import (  # noqa: F401
    data_axis_size,
    init_distributed,
    make_mesh,
    spawn,
)
from instantvnr_torch.parallel.train import (  # noqa: F401
    make_dp_hostbatch_step,
    make_dp_train_step,
    replicate_state,
    shard_host_batch,
)
from instantvnr_torch.parallel.render import make_sharded_render_fn  # noqa: F401
