from . import api, distributed, dshard, mesh, reshard, tiling  # noqa: F401
