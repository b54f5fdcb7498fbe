from .drawers import FrameDrawer, MapDrawer, TrajectoryPlotter
