"""External-middleware integrations (ROS nodes, message adapters)."""
