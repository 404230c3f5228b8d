from vn_pointcloudcompletion_tpu_torch.visualization.visualization import plot_pcd_one_view  # noqa: F401
