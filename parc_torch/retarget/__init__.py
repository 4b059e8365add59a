"""Keypoint retargeting onto a CharModel or a URDF robot."""
