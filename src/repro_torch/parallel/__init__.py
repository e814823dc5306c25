from repro_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshEntry, SearchMesh, current_mesh, init_distributed,
    make_host_mesh, make_mesh, make_search_mesh, mesh_from_devices,
    mesh_is_multihost, mesh_num_devices, process_count,
)
