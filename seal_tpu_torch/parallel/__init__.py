"""seal_tpu_torch.parallel: the port of seal_tpu/parallel/ on torch.distributed.

One process per rank (launch.run), a (dp, tp) grid of ranks (sharding.HEMesh),
the collectives and their census (comm.py), the tensor-parallel key switch
(keyswitch.py), the coefficient-sharded four-step NTT (fourstep.py), the
pipeline schedule (pipeline.py), and dryrun.py, the counterpart of
__graft_entry__.py's dryrun_multichip. On the CPU the ranks use gloo and
contexts with device="cpu"; on cards NCCL, one rank per card, or gloo ranks
sharing one card, whose collectives pass through the host.
"""

from seal_tpu_torch.parallel.sharding import (
    HEMesh,
    batch_ciphertexts,
    shard_ciphertext,
    unbatch_ciphertexts,
    vmap_pipeline,
)
from seal_tpu_torch.parallel.keyswitch import TPEvaluator, TPKeySwitch, tp_relinearize

__all__ = ["HEMesh", "TPEvaluator", "TPKeySwitch", "batch_ciphertexts", "shard_ciphertext",
           "tp_relinearize", "unbatch_ciphertexts", "vmap_pipeline"]
