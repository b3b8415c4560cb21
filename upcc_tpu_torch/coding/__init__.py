"""Native host coders (rANS, octree) and the voxelizer, built with g++."""
