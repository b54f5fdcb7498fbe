"""The example drivers, each at the name of its counterpart in the JAX
package's examples/ and runnable as
`python -m orb_slam2_detailed_comments_tpu_torch.examples.<name>` or as a
script path:

  run_slam          the unified dataset driver (TUM, KITTI, EuRoC; six modes)
  mono_tum, rgbd_tum, mono_kitti, stereo_kitti, mono_euroc, stereo_euroc
                    the reference's per-dataset mains
  ros_mono, ros_rgbd, ros_stereo, ros_mono_ar
                    the ROS nodes (need rospy)
  train_vocabulary  offline vocabulary training

Each has a main(argv=None) and takes --device (default cuda).
"""
