"""dsjax's mesh settings under DDP: the counterpart of dsjax/parallel/mesh.py.

dsjax builds a ('dcn', 'data', 'model') device mesh and shards the batch
over ('dcn', 'data'). Under DDP the batch spans every rank, one card a
rank, and NCCL picks its own hierarchical algorithm across nodes, so the
settings become checks against the world size:

  * ``trainer.mesh_dcn`` (slices, that is nodes) must divide the world size;
  * ``trainer.mesh_data`` must be -1 or world size / mesh_dcn;
  * ``trainer.mesh_model`` > 1 (dsjax shards w_ih/w_hh over a 'model' axis,
    ``param_shardings``) is not ported (ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations


def check_mesh(mesh_data: int, mesh_model: int, mesh_dcn: int, world: int) -> None:
    """Raise unless the mesh settings describe ``world`` data-parallel
    ranks."""
    if mesh_model != 1:
        raise NotImplementedError(
            f"trainer.mesh_model={mesh_model}: tensor-parallel recurrent layers are not "
            f"ported (ROADMAP.md, Queue 1 item 11); every rank holds the whole model")
    if mesh_dcn < 1 or world % mesh_dcn:
        raise ValueError(f"trainer.mesh_dcn={mesh_dcn} does not divide the world size "
                         f"{world}")
    if mesh_data not in (-1, world // mesh_dcn):
        raise ValueError(f"trainer.mesh_data={mesh_data} does not match {world} ranks over "
                         f"{mesh_dcn} node(s): leave it at -1 or set it to "
                         f"{world // mesh_dcn}")
