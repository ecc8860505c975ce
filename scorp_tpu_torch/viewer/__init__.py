from .network_gui import NetworkGUI, gui_tick, maybe_create_gui  # noqa: F401
