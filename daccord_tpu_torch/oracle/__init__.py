from .align import align_path, edit_distance, infix_distance, overlap_suffix_prefix
from .consensus import (ConsensusConfig, estimate_profile_two_pass,
                        make_offset_likely, solve_window, stitch_results)
from .dbg import DBGParams, WindowResult, window_consensus
from .profile import ErrorProfile, OffsetLikely
from .windows import RefinedOverlap, WindowSegments, cut_windows, refine_overlap

__all__ = ["align_path", "edit_distance", "infix_distance", "overlap_suffix_prefix",
           "ConsensusConfig", "estimate_profile_two_pass", "make_offset_likely",
           "solve_window", "stitch_results", "DBGParams", "WindowResult",
           "window_consensus", "ErrorProfile", "OffsetLikely",
           "RefinedOverlap", "WindowSegments", "cut_windows", "refine_overlap"]
