"""Native host coders (rANS, octree, occupancy) and the voxelizer, built
with g++, each with a pure-Python (voxelizer: numpy) twin that writes the
same bytes where g++ cannot build it."""
