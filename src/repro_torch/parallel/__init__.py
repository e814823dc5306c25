from repro_torch.parallel.mesh import (  # noqa: F401
    MeshEntry, SearchMesh, init_distributed, make_search_mesh,
    mesh_from_devices, mesh_is_multihost, mesh_num_devices, process_count,
)
