# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tts.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\ttts.proto\x12\x07\x66\x35\x65_tts\"\x80\x01\n\nTTSRequest\x12\x10\n\x08gen_text\x18\x01 \x01(\t\x12\x10\n\x08ref_text\x18\x02 \x01(\t\x12\x13\n\x0bref_pcm_f32\x18\x03 \x01(\x0c\x12\x17\n\x0fref_sample_rate\x18\x04 \x01(\x05\x12\x11\n\tnfe_steps\x18\x05 \x01(\x05\x12\r\n\x05speed\x18\x06 \x01(\x02\"D\n\nAudioChunk\x12\x0f\n\x07pcm_f32\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x10\n\x08is_final\x18\x03 \x01(\x08\x32~\n\x03TTS\x12\x38\n\nSynthesize\x12\x13.f5e_tts.TTSRequest\x1a\x13.f5e_tts.AudioChunk0\x01\x12=\n\x11SynthesizeOffline\x12\x13.f5e_tts.TTSRequest\x1a\x13.f5e_tts.AudioChunkb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tts_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TTSREQUEST._serialized_start=23
  _TTSREQUEST._serialized_end=151
  _AUDIOCHUNK._serialized_start=153
  _AUDIOCHUNK._serialized_end=221
  _TTS._serialized_start=223
  _TTS._serialized_end=349
# @@protoc_insertion_point(module_scope)
