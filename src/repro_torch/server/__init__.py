from repro_torch.server.update import (  # noqa: F401
    SERVER_UPDATES, ServerUpdate, as_server_update, get_server_update)
