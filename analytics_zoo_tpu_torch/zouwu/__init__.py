"""Zouwu: time-series forecasting (ref ``pyzoo/zoo/zouwu/``): so far the
TCN, LSTM and Seq2Seq forecasters (``model/``); the feature transform,
anomaly detection, AutoTS, MTNet and TCMF are ROADMAP A11."""
