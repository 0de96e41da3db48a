from .generator import (TrajectoryGenerator, TrajectorySegment,
                        load_waypoints_csv, read_library_csv,
                        write_library_csv)

__all__ = [
    "TrajectoryGenerator", "TrajectorySegment",
    "load_waypoints_csv", "write_library_csv", "read_library_csv",
]
