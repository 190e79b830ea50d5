"""The offline WAI data pipeline of the port: conversion of raw datasets, covisibility,
aggregation, depth-consistency confidence, pseudo-depth, mesh rendering, undistortion."""
