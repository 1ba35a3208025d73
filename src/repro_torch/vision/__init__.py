from .synapse_detector import (Detection, connected_components,
                               detect_synapses, detect_tile,
                               difference_of_gaussians, gaussian_blur,
                               large_structure_mask, run_parallel_detection,
                               scale_mask, tiling)

__all__ = ["Detection", "connected_components", "detect_synapses",
           "detect_tile", "difference_of_gaussians", "gaussian_blur",
           "large_structure_mask", "run_parallel_detection", "scale_mask",
           "tiling"]
