"""The multi-device rungs: work split over a mesh of torch devices."""
