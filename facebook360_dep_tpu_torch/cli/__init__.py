"""The port's command-line entry points, each run as ``python -m
facebook360_dep_tpu_torch.cli.<name>`` or called as ``main(argv)`` with the
JAX CLI's flags (those that compute on a device also take ``device``, None
meaning the card): derp_cli; compute_rephotography_errors and
simple_mesh_renderer; generate_foreground_masks, resize_images,
temporal_bilateral_filter, upsample_disparity and layer_disparities;
convert_to_binary and view_fused (the 6DoF publish and playback path);
calibration (main, main_match_corners, main_geometric), align_point_cloud
and align_colors, with rig_aligner and rig_compare on the host (rig
calibration)."""
