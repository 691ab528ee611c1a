"""Query execution: the Engine facade, the batch executor with its host
tree planner, and the device-resident catalog."""
